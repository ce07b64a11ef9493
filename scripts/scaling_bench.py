#!/usr/bin/env python3
"""Multi-process scaling-efficiency benchmark (BASELINE >=0.8 target).

Weak-scaling harness for the distributed encode path: N processes, each
owning one virtual CPU device, assemble a global 1-D mesh via
``jax.distributed`` and run the sharded encode pipeline
(``parallel.batch._build``) over a batch of ``--per-proc`` images each.
The pipeline's overflow check is a cross-process ``pmax``, so every
timed step includes a real collective -- the same program structure as
a multi-host job (SURVEY 2.4, BASELINE config 5); the reference has no
distributed anything to compare against, so efficiency is measured
against our own N=1.

Efficiency(N) = MP/s(N) / (N * MP/s(1))   [weak scaling: per-process
workload fixed, total grows with N].

Prints the JSON record (``--out=PATH`` also writes it).  Rows with more
processes than cores are oversubscribed and understate efficiency; the
record carries ``cores`` so readers can judge.  These are CPU numbers:
they check the multi-process structure, not a device's scaling.

Usage:
    python scripts/scaling_bench.py [--procs 1,2] [--per-proc 4] \
        [--pipelines xla,decode]
    python scripts/scaling_bench.py _worker <coord> <n> <pid> <outdir> \
        <per_proc> <size> <reps> <pipeline>          (internal)
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker():
    coord, n, pid, outdir, per, size, reps, pipeline = sys.argv[2:10]
    n, pid, per, size, reps = map(int, (n, pid, per, size, reps))
    sys.path.insert(0, REPO)

    # one core per process (XLA's CPU thread pool would otherwise let
    # the N=1 baseline use every core, skewing efficiency downward)
    try:
        ncores = os.cpu_count() or 1
        os.sched_setaffinity(0, {pid % ncores})
    except (AttributeError, OSError):
        pass

    import jax

    jax.config.update("jax_platforms", "cpu")
    if n > 1:
        jax.distributed.initialize(
            coordinator_address=coord, num_processes=n, process_id=pid
        )
    assert jax.device_count() == n, jax.devices()

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tinyimgcodec_tpu import corpus
    from tinyimgcodec_tpu.parallel.batch import _build
    from tinyimgcodec_tpu.parallel.mesh import make_mesh
    from tinyimgcodec_tpu.parallel.tiled import _MeshKey

    mesh = make_mesh()
    sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    local = corpus.synthetic_corpus(per, size)
    images = jax.make_array_from_process_local_data(
        sharding, local, (n * per, size, size)
    )

    if pipeline == "decode":
        # sharded DECODE (round-4 verdict #6): each process entropy-
        # decodes + inverse-transforms its shard of TICX streams via
        # the shard_map body (pure XLA).  Workload: each process compresses its local images
        # once (host oracle), then times the device decode only.
        from tinyimgcodec_tpu import container
        from tinyimgcodec_tpu.ops.entropy_decode import prepare_batch
        from tinyimgcodec_tpu.parallel.batch import (
            _build_decode_sharded,
        )

        streams = [
            container.compress(
                np.asarray(local[i]), 50, block_index=True
            )
            for i in range(per)
        ]
        prep = prepare_batch(streams)
        assert prep is not None
        h, w, _q = prep["shape"]
        nb = prep["nb_per_image"]
        stride = prep["stride"]
        # synthetic_corpus is deterministic, so every process derives
        # identical bucket/c_max and the shared program agrees
        wl = len(prep["words"])
        bucket = 1 << max(10, (wl - 1).bit_length())
        keys = ("chunk_start", "chunk_blocks", "chunk_block_base",
                "chunk_end_lo", "chunk_end_hi")
        c_max = len(prep["chunk_start"])
        wloc = np.zeros((1, bucket), np.uint32)
        wloc[0, :wl] = prep["words"]
        carrs = {}
        for k in keys:
            a = np.zeros((1, c_max), np.int32)
            a[0, : len(prep[k])] = prep[k]
            carrs[k] = a
        gw = jax.make_array_from_process_local_data(
            sharding, wloc, (n, bucket)
        )
        gargs = tuple(
            jax.make_array_from_process_local_data(
                sharding, carrs[k], (n, c_max)
            )
            for k in keys
        )
        h8, w8 = -(-h // 8) * 8, -(-w // 8) * 8
        from tinyimgcodec_tpu.ops.entropy_decode import (
            suggest_budget_rows,
        )

        fn = _build_decode_sharded(
            _MeshKey(mesh), per, nb, bucket, c_max, 50, "fast", False,
            stride, h8, w8,
            suggest_budget_rows(wl, per * nb, stride, margin=1.5),
        )

        def run_once():
            imgs, ok, flg = fn(gw, *gargs)
            okl = np.asarray(ok.addressable_data(0))
            return not okl.all()
    else:
        fn = _build(_MeshKey(mesh), 50, "fast", None)

        def run_once():
            out = fn(images)
            # overflow is pmax-reduced + replicated: reading it syncs all
            # processes, so wall time includes the collective every step
            return bool(np.asarray(out[-1].addressable_data(0)))

    run_once()  # compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        assert not run_once()
        times.append(time.perf_counter() - t0)
    rec = {"pid": pid, "times": times}
    with open(os.path.join(outdir, f"proc_{pid}.json"), "w") as f:
        json.dump(rec, f)
    print(f"proc {pid}/{n} median {sorted(times)[len(times)//2]:.4f}s",
          flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_config(n: int, per: int, size: int, reps: int, outdir: str,
                pipeline: str = "xla"):
    os.makedirs(outdir, exist_ok=True)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        # one XLA compute thread per process: honest core accounting
        # when processes > cores is impossible, but at least uniform
        XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                  "--xla_force_host_platform_device_count=1",
    )
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "_worker",
             coord, str(n), str(pid), outdir, str(per), str(size),
             str(reps), pipeline],
            env=env, cwd=REPO,
        )
        for pid in range(n)
    ]
    deadline = time.time() + 600
    for p in procs:
        p.wait(timeout=max(1, deadline - time.time()))
        if p.returncode != 0:
            raise RuntimeError(f"worker failed (rc={p.returncode})")
    per_proc = []
    for pid in range(n):
        with open(os.path.join(outdir, f"proc_{pid}.json")) as f:
            per_proc.append(json.load(f)["times"])
    # per rep, the slowest process bounds the step (collective barrier)
    step = [max(t[i] for t in per_proc)
            for i in range(len(per_proc[0]))]
    med = sorted(step)[len(step) // 2]
    mp = n * per * size * size / 1e6
    return mp / med


def main():
    # default --procs 1,2: rows with more processes than cores are
    # oversubscription artifacts, not scaling evidence
    args = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    procs = [int(x) for x in args.get("--procs", "1,2").split(",")]
    per = int(args.get("--per-proc", "4"))
    size = int(args.get("--size", "512"))
    reps = int(args.get("--reps", "5"))
    pipelines = args.get(
        "--pipelines", "xla,decode"
    ).split(",")
    cores = os.cpu_count() or 1

    import tempfile

    by_pipeline = {}
    for pipeline in pipelines:
        psize, pper = size, per
        if pipeline == "decode":
            # the CPU-compiled worst-case chain is seconds/rep at 512^2
            psize = int(args.get("--size-decode", "256"))
            pper = 2
        rows = []
        base = None
        for n in procs:
            with tempfile.TemporaryDirectory() as td:
                mps = _run_config(n, pper, psize, reps, td, pipeline)
            if base is None:
                base = mps / n  # MP/s per process at the ref point
            eff = mps / (n * base)
            row = {"procs": n, "mps": round(mps, 3),
                   "efficiency": round(eff, 3)}
            if n > cores:
                row["oversubscribed"] = True
            rows.append(row)
            print(f"[{pipeline}] N={n}: {mps:.2f} MP/s, "
                  f"efficiency {eff:.3f}", flush=True)
        by_pipeline[pipeline] = {
            "per_proc_images": pper, "image_size": psize, "rows": rows,
        }

    record = {
        "benchmark": "weak_scaling_sharded_encode",
        "platform": "cpu-virtual-mesh",
        "cores": cores,
        "quality": 50,
        "note": (
            "N processes x 1 device each over jax.distributed; CPU "
            "stand-in for hosts. Only rows with procs <= cores are "
            "scaling evidence; oversubscribed rows (if requested) are "
            "flagged. 'xla' = shard_map XLA encode pipeline; 'decode' = "
            "sharded TICX device entropy decode + transform."
        ),
        "pipelines": by_pipeline,
    }
    if "--out" in args:
        with open(args["--out"], "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "_worker":
        _worker()
    else:
        main()
