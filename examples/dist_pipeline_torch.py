"""Distributed pipeline execution on PyTorch: the shipped Deployment
artifact running on real workers, validated against the in-process
oracle.

The counterpart of ``examples/dist_pipeline.py`` in the port
(``repro_torch``).  A SqueezeNet deployment on a 3-Pi cluster is
launched as a chain of persistent stage workers (threads + in-memory
wire links here; ``DistSpec(transport="tcp", workers="process")`` for
real OS processes over sockets — same codec, same bytes), each
computing on ``--device`` (default ``cuda``; ``cpu`` runs the conv
kernel's plain version).  Workers receive only the versioned JSON
artifact, rebuild weights deterministically, and stream frames
``recv -> compiled stage -> send``.  The run ends with a churn drill:
one worker is killed mid-stream, its loss is accounted frame by frame,
and a re-plan on the surviving devices recovers every frame
bit-identically.  ``--peer-timeout`` is the drill's heartbeat silence
that declares a worker dead (the JAX example's 0.6 s by default).

    PYTHONPATH=src python examples/dist_pipeline_torch.py [--device cpu] \\
        [--peer-timeout 0.6]
"""

import argparse

import numpy as np

import repro_torch
from repro_torch.core import make_pi_cluster
from repro_torch.dist import make_frames, validate
from repro_torch.dist.validate import reference_outputs
from repro_torch.models.cnn import zoo

#: the drill's heartbeat silence that declares a worker dead (the JAX
#: example's)
PEER_TIMEOUT_S = 0.6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback to cpu)")
    ap.add_argument("--peer-timeout", type=float, default=PEER_TIMEOUT_S,
                    help="seconds of heartbeat silence that declare the "
                         "drill's killed worker dead")
    args = ap.parse_args(argv)
    device = repro_torch.require_device(args.device)

    # 1. Plan once, offline (paper Alg.1-3); the artifact is the hand-off
    model = zoo.squeezenet(input_size=(64, 64), scale=0.1)
    cluster = make_pi_cluster([1.5, 1.2, 1.0], bandwidth_mbps=50.0)
    dep = repro_torch.compile(model, cluster, device=device)
    print(dep.describe())

    # 2. Real distributed execution, validated against the simulator
    #    oracle: bit-identical outputs, zero dropped frames, observed
    #    per-stage compute within a sane band of the modeled cost
    v = validate(dep, repro_torch.DistSpec(), frames=5)
    print(v.describe())
    assert v.ok, v.describe()

    # 3. Incremental use: start once, stream frames, clean drain
    launcher = dep.fleet(repro_torch.DistSpec(transport="memory"))
    launcher.start()
    xs = make_frames(model, 6)
    for x in xs:
        launcher.submit(x)
    rep = launcher.shutdown()          # FIFO drain: nothing in flight lost
    assert rep.completed == rep.submitted and not rep.dropped
    streamed = rep
    print(f"streamed {rep.completed}/{rep.submitted} frames, "
          f"dropped={len(rep.dropped)}, "
          f"utilization={rep.utilization():.2f}, "
          f"stages={rep.n_stages} ({rep.workers_mode}/{rep.transport})")

    # 4. Churn drill: kill a worker mid-stream; the launcher surfaces
    #    DeviceLeave events and accounts every stranded frame
    drill = dep.fleet(repro_torch.DistSpec(heartbeat_s=0.05,
                                           peer_timeout_s=args.peer_timeout))
    drill.start()
    drill.kill_worker(1)
    rep = drill.run(xs)
    dead = {e.device_name for e in rep.churn_events}
    print(f"churn drill: lost {sorted(dead)}, completed {rep.completed}, "
          f"dropped {len(rep.dropped)} (reasons recorded per frame)")
    assert rep.completed + len(rep.dropped) == rep.submitted

    # 5. Drain-and-repartition: re-plan on the survivors, resubmit the
    #    stranded frames, and the merged stream is bit-identical to the
    #    single-process oracle
    alive = [d for d in cluster.devices if d.name not in dead]
    dep2 = dep.replan(cluster.restricted(alive))
    missing = sorted(set(range(len(xs))) - set(rep.outputs))
    rep2 = dep2.fleet(repro_torch.DistSpec()).run([xs[i] for i in missing])
    merged = dict(rep.outputs)
    merged.update({fid: rep2.outputs[k] for k, fid in enumerate(missing)})
    ref = reference_outputs(dep, xs)
    assert all(np.array_equal(merged[i][s], ref[i][s])
               for i in range(len(xs)) for s in ref[i])
    print(f"recovered {len(missing)} stranded frame(s) on "
          f"{len(alive)} surviving devices — all outputs bit-identical ✓")
    return {"validation": v, "streamed": streamed, "dead": sorted(dead),
            "drill": rep, "recovered": len(missing),
            "stages": [(s.first_piece, s.last_piece,
                        [d.name for d in s.devices])
                       for s in dep.pipeline.stages],
            "period": dep.period,
            "replanned": [(s.first_piece, s.last_piece,
                           [d.name for d in s.devices])
                          for s in dep2.pipeline.stages],
            "replanned_period": dep2.period}


if __name__ == "__main__":             # required: spawn-safe entry point
    main()
