"""Tackling a wide NAS graph with divide-and-conquer on PyTorch's port
(paper §6.2.3, 'NASNetL-P'): direct Algorithm 1 is intractable for w=8
graphs; the chunked D&C partitions it in seconds.

The counterpart of ``examples/nasnet_dnc.py`` in the port
(``repro_torch``), at the same sizes.  It only plans: no weights, no
device.

    PYTHONPATH=src python examples/nasnet_dnc_torch.py
"""

import argparse
import time

from repro_torch.core import make_pi_cluster, partition_graph_dnc, plan
from repro_torch.models.cnn import zoo


def main(argv=None, n_cells: int = 6, width: int = 6) -> dict:
    """The example at ``n_cells`` cells of ``width`` branches (the JAX
    example's 6 and 6 by default)."""
    argparse.ArgumentParser(description=__doc__.splitlines()[0]
                            ).parse_args(argv)

    model = zoo.nasnet_cells(n_cells=n_cells, input_size=(128, 128),
                             scale=0.25, width=width, name="nasnetl-p")
    g = model.graph
    D = 5
    n, w = len(g.layers), g.width()
    bound = w * D * (n * D / w) ** w
    print(f"NASNet-style graph: n={n} vertices, width w={w}; "
          f"direct Alg.1 bound ~{bound:.2g} states -> divide & conquer")

    t0 = time.time()
    part = partition_graph_dnc(g, model.input_size, n_split=4, chunk=24)
    print(f"D&C produced {len(part.pieces)} chain pieces in "
          f"{time.time()-t0:.1f}s (worst redundancy {part.objective:.3g})")

    cluster = make_pi_cluster([1.5, 1.2, 1.0, 0.8])
    pico = plan(g, cluster, model.input_size, pieces=part.pieces)
    print(f"pipeline: {len(pico.pipeline.stages)} stages, "
          f"period {pico.period*1e3:.1f} ms, "
          f"throughput {60/pico.period:.1f} frames/min")
    return {"n": n, "w": w, "pieces": [p.nodes for p in part.pieces],
            "objective": part.objective,
            "stages": [(s.first_piece, s.last_piece,
                        [d.name for d in s.devices])
                       for s in pico.pipeline.stages],
            "period": pico.period}


if __name__ == "__main__":
    main()
