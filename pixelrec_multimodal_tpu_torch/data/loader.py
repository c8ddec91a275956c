# pixelrec_multimodal_tpu_torch/data/loader.py
"""Host -> device prefetching batch loader.

Counterpart of ``pixelrec_multimodal_tpu/data/loader.py``: one background
thread assembles the next host batches and starts their copies to the
device while the current step runs, through a bounded queue (double
buffering at ``prefetch=2``). Errors behave as in the JAX package: an
exception raised while assembling a batch reaches the consumer after the
batches before it. A consumer that stops early makes the thread stop after
the batch in flight; it pulls no batch from the iterable once the consumer
has cancelled (the JAX package's thread may pull one more).

On a CUDA device a batch goes through pinned host memory and a
``non_blocking`` copy on a side stream; the consumer's stream waits on
that copy's event before the batch is used, and each tensor records the
consumer's stream so that its memory is not reused while a step still
reads it. On the CPU the arrays become tensors as they are (no pinning:
a CPU-only PyTorch cannot pin memory).

With a ``mesh`` (``parallel/mesh.py``) each rank moves only its rows of
each batch, the leading axis split over 'data' (JAX's ``batch_sharding``
in ``device_put``).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.mesh import shard_batch


class PrefetchLoader:
    """Iterate device-resident batches, assembled ahead of consumption.

    Parameters
    ----------
    batches:
        Host-batch iterable (dicts of numpy arrays), e.g.
        ``dataset.batches(bs)``.
    prefetch:
        Batches to keep in flight beyond the one being consumed
        (2 = double buffering).
    device:
        Where the batches go: ``'cuda'`` (the default) or ``'cpu'``.
    transform:
        Optional host-side callable applied to each batch dict before
        transfer (e.g. dtype casts).
    mesh:
        Optional mesh: each batch's rows are split over its 'data' axis
        and this rank moves only its own (every length must divide).
    """

    _END = object()

    def __init__(self, batches: Iterable[Dict[str, np.ndarray]],
                 prefetch: int = 2,
                 device: Union[str, torch.device] = 'cuda',
                 transform: Optional[Callable[[dict], dict]] = None,
                 mesh=None):
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        self._batches = batches
        self._prefetch = prefetch
        self._device = resolve_device(device)
        self._transform = transform
        self._mesh = mesh

    def _to_device(self, host_batch: dict, stream):
        """(tensors on the device, the copy's event or None)."""
        if stream is None:
            return {k: torch.as_tensor(np.asarray(v))
                    for k, v in host_batch.items()}, None
        with torch.cuda.stream(stream):
            dev = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self._device, non_blocking=True)
                   for k, v in host_batch.items()}
            return dev, stream.record_event()

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()
        err: list = []
        cuda = self._device.type == 'cuda'
        stream = torch.cuda.Stream(self._device) if cuda else None

        def worker():
            try:
                for host_batch in self._batches:
                    if stop.is_set():
                        return
                    if self._transform is not None:
                        host_batch = self._transform(host_batch)
                    if self._mesh is not None:
                        host_batch = shard_batch(host_batch, self._mesh)
                    item = self._to_device(host_batch, stream)
                    # Bounded put that stays responsive to cancellation.
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.05)
                            break
                        except queue.Full:
                            pass
                    # A put that a cancelled consumer's drain let through
                    # must not pull another batch from the iterable.
                    if stop.is_set():
                        return
            except BaseException as e:  # surfaced in the consumer's thread
                err.append(e)
            finally:
                # The END sentinel must reach a live consumer even when the
                # queue is momentarily full; only a cancelled (draining)
                # consumer may go without it.
                while True:
                    try:
                        q.put(self._END, timeout=0.05)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        t = threading.Thread(target=worker, daemon=True,
                             name='pixelrec-prefetch')
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._END:
                    break
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self._device)
                    current.wait_event(event)
                    for v in batch.values():
                        v.record_stream(current)
                yield batch
        finally:
            # Early consumer exit: tell the worker to stop after the batch
            # in flight, then drain.
            stop.set()
            while t.is_alive():
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
        if err:
            raise err[0]


def prefetch_to_device(batches: Iterable[Dict[str, np.ndarray]],
                       prefetch: int = 2,
                       device: Union[str, torch.device] = 'cuda'
                       ) -> Iterator[dict]:
    """Functional shorthand: ``for b in prefetch_to_device(ds.batches(...))``."""
    return iter(PrefetchLoader(batches, prefetch=prefetch, device=device))
