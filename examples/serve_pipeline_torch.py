"""End-to-end serving on PyTorch (the paper's deployment): a
Poisson stream of camera frames served by a PICO-planned pipeline over a
heterogeneous cluster, with real numerics and model-time statistics.

The counterpart of ``examples/serve_pipeline.py`` in the port
(``repro_torch``): the same model, cluster, stream and statistics; the
stages compute on ``--device`` (default ``cuda``, through the
hand-written conv kernel; ``cpu`` runs its plain version).

    PYTHONPATH=src python examples/serve_pipeline_torch.py [--device cpu]
"""

import argparse

import numpy as np

import repro_torch
from repro_torch.core import make_pi_cluster
from repro_torch.data.pipeline import RequestStream
from repro_torch.models.cnn import zoo
from repro_torch.serving import PipelineServer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback to cpu)")
    device = repro_torch.require_device(ap.parse_args(argv).device)

    model = zoo.resnet34(input_size=(128, 128), scale=0.25)
    cluster = make_pi_cluster([1.5, 1.5, 1.2, 1.2, 0.8, 0.8])

    server = PipelineServer(model, cluster, device=device).load()
    plan = server.pico
    print(f"pipeline: {len(plan.pipeline.stages)} stages, "
          f"period {plan.period*1e3:.1f} ms, "
          f"latency {plan.latency*1e3:.1f} ms")

    # Poisson arrivals at ~80% of pipeline capacity
    rate = 0.8 / plan.period
    H, W = model.input_size[1], model.input_size[0]

    def payload(rng, i):
        return rng.standard_normal((1, H, W, 3)).astype(np.float32)

    requests = RequestStream(rate_per_s=rate, seed=0).generate(24, payload)
    outputs, stats = server.serve(requests)

    print(f"served {stats.served} requests "
          f"(wall {stats.wall_s:.1f}s on {device})")
    print(f"model-time throughput: {stats.model_throughput_per_min:.1f}/min")
    lat = np.array(stats.per_request)
    p50, p95 = np.percentile(lat, 50), np.percentile(lat, 95)
    print(f"model-time latency: p50 {p50*1e3:.0f} ms, p95 {p95*1e3:.0f} ms")
    out0 = outputs[0]
    print("first output:", {k: tuple(v.shape) for k, v in out0.items()})
    assert stats.served == len(requests)
    print(f"served every request on {device} ✓")
    return {"served": stats.served, "period": plan.period,
            "latency": plan.latency,
            "throughput_per_min": stats.model_throughput_per_min,
            "per_request": list(stats.per_request), "p50": p50, "p95": p95,
            "outputs": outputs}


if __name__ == "__main__":
    main()
