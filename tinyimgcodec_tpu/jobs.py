"""Checkpointable corpus jobs (SURVEY 5 checkpoint/resume + failure
recovery equivalents).

Encode is stateless per image, so corpus-scale work checkpoints at image
granularity: a manifest JSON tracks which inputs are done; re-running the
job skips completed items and picks up where it left off after a crash or
preemption (the multi-host analog restarts the failed batch only).
Streaming output: each image's bitstream lands in its own file as soon as
it is encoded, so consumers see valid prefixes of the corpus while the
job runs (the analog of the reference C encoder's incremental FIFO
drain, c/encode.c:59).
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np


class CorpusEncodeJob:
    """Encode a set of images to .img files with resume support."""

    def __init__(
        self,
        out_dir: str,
        quality: int = 50,
        backend: str = "auto",
        batch_size: int = 16,
    ) -> None:
        self.out_dir = out_dir
        self.quality = quality
        self.backend = backend
        self.batch_size = batch_size
        self.manifest_path = os.path.join(out_dir, "manifest.json")
        os.makedirs(out_dir, exist_ok=True)
        self._manifest = self._load_manifest()

    def _load_manifest(self) -> dict:
        if os.path.exists(self.manifest_path):
            try:
                with open(self.manifest_path) as f:
                    return json.load(f)
            except (OSError, json.JSONDecodeError):
                pass
        return {"quality": self.quality, "done": {}}

    def _save_manifest(self) -> None:
        # atomic write so a crash never corrupts resume state
        fd, tmp = tempfile.mkstemp(dir=self.out_dir, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(self._manifest, f)
        os.replace(tmp, self.manifest_path)

    def pending(self, names: list[str]) -> list[str]:
        done = self._manifest["done"]
        return [n for n in names if n not in done]

    def _encode_batch(self, batch: list[np.ndarray]) -> list[bytes]:
        """Encode a same-shaped batch through the public batch API: one
        SPMD dispatch over every local device instead of per-image
        syncs (the host oracle under backend="host").  Errors raise."""
        from . import api

        return api.compress_batch(
            np.stack(batch), quality=self.quality, backend=self.backend,
        )

    def run(
        self, images: dict[str, np.ndarray], progress=None
    ) -> dict[str, str]:
        """Encode all not-yet-done images; returns name -> output path.

        Same-shaped images are encoded through the batch pipeline in
        ``batch_size`` chunks (throughput ~= the batch benchmark's, not
        single-image dispatch latency); checkpointing stays per-image, so
        resume granularity is unchanged.
        """
        names = self.pending(sorted(images))
        out_paths = {
            n: os.path.join(self.out_dir, f"{n}.img")
            for n in sorted(images)
        }

        # chunk by shape so each dispatch is one static-shape SPMD program
        chunks: list[list[str]] = []
        cur: list[str] = []
        for name in names:
            if cur and (
                images[name].shape != images[cur[-1]].shape
                or len(cur) >= self.batch_size
            ):
                chunks.append(cur)
                cur = []
            cur.append(name)
        if cur:
            chunks.append(cur)

        done_count = 0
        for chunk in chunks:
            streams = self._encode_batch([images[n] for n in chunk])
            for name, data in zip(chunk, streams):
                tmp = out_paths[name] + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, out_paths[name])
                self._manifest["done"][name] = {
                    "bytes": len(data), "shape": list(images[name].shape)
                }
                self._save_manifest()
                done_count += 1
                if progress:
                    progress(done_count, len(names), name)
        return out_paths
