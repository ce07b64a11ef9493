"""Worker process for the multi-process (multi-host analog) test.

Each process owns one CPU device; jax.distributed assembles the global
2-device mesh — the same program structure as a multi-host job
(BASELINE config 5), with cross-process collectives standing in for the interconnect.
Each worker feeds its local image shard, runs the sharded encode (whose
overflow check is a cross-process pmax), and writes its local results.

Usage: python distributed_worker.py <coordinator> <nprocs> <pid> <outdir>
"""

import os
import sys


def main():
    coordinator, nprocs, pid, outdir = sys.argv[1:5]
    nprocs, pid = int(nprocs), int(pid)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=nprocs,
        process_id=pid,
    )
    assert jax.device_count() == nprocs, jax.devices()

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tinyimgcodec_tpu import corpus
    from tinyimgcodec_tpu.parallel.batch import _build
    from tinyimgcodec_tpu.parallel.mesh import make_mesh
    from tinyimgcodec_tpu.parallel.tiled import _MeshKey

    per = 2  # images per process
    mesh = make_mesh()
    sharding = NamedSharding(mesh, P(mesh.axis_names[0]))

    # every process materializes only ITS images (data-parallel loading)
    all_imgs = corpus.synthetic_corpus(nprocs * per, 32)
    local = all_imgs[pid * per : (pid + 1) * per]
    global_shape = (nprocs * per, 32, 32)
    images = jax.make_array_from_process_local_data(
        sharding, local, global_shape
    )

    fn = _build(_MeshKey(mesh), 50, "fast", None)
    words, block_bits, flags, dc, overflow = fn(images)
    # overflow is a cross-process pmax-reduced replicated scalar
    assert not bool(np.asarray(overflow.addressable_data(0)))

    w_local = np.asarray(words.addressable_data(0))
    b_local = np.asarray(block_bits.addressable_data(0))
    np.savez(
        os.path.join(outdir, f"shard_{pid}.npz"),
        words=w_local, bits=b_local,
    )
    print(f"proc {pid} done", flush=True)


if __name__ == "__main__":
    main()
