"""Threaded prefetching input pipeline (port of ``avr_tpu/data/prefetch.py``).

Overlaps host-side batch assembly (HDF5 reads, ray-index sampling, numpy
gathers, the upload of the step's tensors) with device execution, so the
card need not wait on the host between optimizer steps.  It is what
``fit``'s host path uses by default (``FitConfig.prefetch``).

Determinism: each step's assembly RNG derives from ``(seed, global step)``
and the epoch's data order from the dataset's ``epoch_seed`` mechanism, so
the prefetched stream is bitwise identical to the synchronous one and to a
resumed run (deterministic-resume contract).

Usage::

    pipe = PrefetchPipeline(dset, batch_size=4, ray_batch_size=512,
                            num_source_views=1, with_bbox=False, depth=2)
    for gstep, (src_images, src_poses, focal, c, model_input, gt) in \
            pipe.epoch(epoch_seed=0, start_step=0):
        state, metrics = train_step(state, ...)
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

import torch

from avr_tpu_torch.data.dataset import SceneClassDataset

__all__ = ["PrefetchPipeline"]

_DONE = object()


class PrefetchPipeline:
    def __init__(
        self,
        dset: SceneClassDataset,
        batch_size: int,
        ray_batch_size: int,
        num_source_views: int = 1,
        with_bbox: bool = False,
        depth: int = 2,
        seed: int = 0,
        device: Optional[torch.device] = None,
    ):
        self.dset = dset
        self.batch_size = batch_size
        self.ray_batch_size = ray_batch_size
        self.num_source_views = num_source_views
        self.with_bbox = with_bbox
        self.depth = depth
        self.seed = seed
        self.device = device

    def _assemble(self, batch, gstep: int):
        from avr_tpu_torch.training.loop import assemble_step_inputs, step_rng

        return assemble_step_inputs(
            step_rng(self.seed, gstep), batch, self.ray_batch_size,
            self.num_source_views, self.with_bbox, device=self.device,
        )

    def epoch(
        self,
        epoch_seed: Optional[int] = None,
        start_step: int = 0,
        skip: int = 0,
        shuffle: bool = True,
    ) -> Iterator[Tuple[int, Tuple]]:
        """Yield ``(global_step, train-step inputs)`` for one epoch,
        prefetched ``depth`` batches ahead on a worker thread.

        ``start_step`` is the epoch's first global step; the first yielded
        batch is epoch batch ``skip`` (global step ``start_step + skip``).
        """
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        err: list = []

        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that stops early sets ``stop``: the worker ends
            # instead of blocking on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for i, batch in enumerate(
                    self.dset.batches(
                        self.batch_size, shuffle=shuffle,
                        epoch_seed=epoch_seed, skip=skip,
                    )
                ):
                    gstep = start_step + skip + i
                    if not put((gstep, self._assemble(batch, gstep))):
                        return
            except BaseException as e:  # propagate into the consumer
                err.append(e)
            finally:
                put(_DONE)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    break
                yield item
        finally:
            stop.set()
            t.join()
        if err:
            raise err[0]
