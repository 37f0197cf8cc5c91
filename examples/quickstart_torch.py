"""Quickstart on PyTorch: compile a PICO deployment for InceptionV3 on a
heterogeneous cluster, execute it on the card, verify it matches the
monolithic network, and round-trip the plan artifact through JSON.

The counterpart of ``examples/quickstart.py`` in the port
(``repro_torch``): the same model, cluster, steps and checks.  The
stages run on ``--device`` (default ``cuda``, through the hand-written
conv kernel; ``cpu`` runs its plain version).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import os
import tempfile

import torch

import repro_torch
from repro_torch.core import make_pi_cluster
from repro_torch.models.cnn import zoo

# pipelined against monolithic outputs, as in the JAX example
RTOL = ATOL = 1e-5


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback to cpu)")
    device = repro_torch.require_device(ap.parse_args(argv).device)

    # 1. A CNN with a non-trivial (block) structure, scaled for CPU demo
    model = zoo.inceptionv3(input_size=(128, 128), scale=0.25)
    print(f"model: {model.name}  vertices={len(model.graph.layers)} "
          f"width={model.graph.width()}")

    # 2. A heterogeneous edge cluster: 4 Raspberry-Pis at mixed frequencies
    cluster = make_pi_cluster([1.5, 1.2, 1.0, 0.8])

    # 3. One call owns the two-step PICO optimization: Alg.1 (graph ->
    #    pieces), Alg.2+3 (pieces x devices -> pipeline stages)
    dep = repro_torch.compile(model, cluster, device=device)
    print(f"pieces: {len(dep.partition.pieces)} "
          f"(worst piece redundancy {dep.partition.objective:.3g} FLOPs)")
    print(dep.describe())

    # 4. Execute the pipeline and check it against the monolithic net
    x = torch.randn((1, 128, 128, 3),
                    generator=torch.Generator().manual_seed(1)).to(device)
    ref = model.forward(dep.load_params().params, x)
    out = dep.run(x)
    for k in ref:
        torch.testing.assert_close(out[k], ref[k], rtol=RTOL, atol=ATOL)
    print(f"pipelined execution matches monolithic forward ✓ on {device}")

    # 5. Steady-state runtime metrics (paper Table 5 quantities)
    rep = dep.simulate(frames=32)
    print(f"simulated: throughput {rep.throughput_per_min:.1f}/min, "
          f"avg util {rep.avg_utilization:.2f}, "
          f"avg redundancy {rep.avg_redundancy:.3f}, "
          f"avg mem {rep.avg_memory/1e6:.1f} MB")

    # 6. The plan is a durable artifact: save, reload (no re-planning, no
    #    re-calibration), and get bit-identical behavior back
    path = dep.save(os.path.join(tempfile.gettempdir(),
                                 "quickstart_torch_plan.json"))
    dep2 = repro_torch.Deployment.load(path, device=device)
    out2 = dep2.run(x)
    for k in out:
        assert torch.equal(out[k], out2[k]), k
    print(f"artifact round-trip ({path}) is bit-identical ✓")
    return {"pieces": len(dep.partition.pieces),
            "objective": dep.partition.objective,
            "stages": [(s.first_piece, s.last_piece,
                        [d.name for d in s.devices])
                       for s in dep.pipeline.stages],
            "period": dep.period, "latency": dep.latency,
            "throughput_per_min": rep.throughput_per_min,
            "avg_utilization": rep.avg_utilization,
            "avg_redundancy": rep.avg_redundancy,
            "avg_memory": rep.avg_memory, "path": path}


if __name__ == "__main__":
    main()
