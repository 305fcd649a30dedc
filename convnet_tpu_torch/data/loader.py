"""Input pipeline: the card-resident batcher and the threaded host loader
(counterpart of convnet_tpu/data/loader.py).

- ``ArrayBatcher``, for in-memory datasets (CIFAR, MNIST, synthetic): the
  whole uint8 dataset lives on the device; a batch is an ``index_select``
  there plus the device transform. No per-step host-to-device copy of
  images.

- ``DataLoader``, for decode-heavy datasets (ImageFolder, indexed tar): a
  thread pool decodes and host-transforms samples (PIL releases the GIL in
  decode and resize), an assembler thread keeps a bounded queue of ready
  uint8 numpy batches, and the consuming thread stages each batch in pinned
  memory, copies it to the card with ``non_blocking=True`` and applies the
  device transform. The worker threads make no CUDA call. Two native paths
  (``data/native.py``) decode a whole batch in C++: an indexed tar, and an
  ImageFolder of JPEGs read on the host. Shuffling is epoch-seeded, as are
  the host draws (``hash((seed, epoch, i, d))``, the same in every Python
  process, so the host batches equal the JAX package's bit for bit);
  ``duplicates`` packs K host-transform draws per sample contiguously;
  ``process_index``/``process_count`` shard the epoch's permutation.

The device transform draws from a ``torch.Generator`` on the batch's device,
seeded from (seed, epoch) when an epoch's iteration starts, and every batch
draws the same amount: a resume that skips the first K batches by iterating
them (``Trainer.train_epoch(start_batch=K)``) augments the rest as the
uninterrupted epoch did.

``CONVNET_TPU_NATIVE_DECODE=0`` turns the native decode off;
``CONVNET_TPU_FAST_DCT=1`` decodes training crops at a reduced DCT scale.
Both change the host decode only.
"""

from __future__ import annotations

import logging
import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from convnet_tpu_torch.core.device import resolve_device
from convnet_tpu_torch.data.preprocess import Transform

log = logging.getLogger(__name__)


def _epoch_permutation(n, epoch, seed, shuffle):
    if not shuffle:
        return np.arange(n)
    rng = np.random.default_rng(np.uint32([seed, epoch]))
    return rng.permutation(n)


def epoch_generator(device, seed: int, epoch: int) -> torch.Generator:
    """The device transform's generator for one epoch, on ``device``."""
    state = np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) & (2 ** 63 - 1))


def _host_seed(seed, epoch, i, d):
    return hash((seed, epoch, int(i), d)) & 0x7FFFFFFF


class ArrayBatcher:
    """Card-resident batching for ArrayDataset-style datasets. ``device``:
    where the data lives and the transform runs; ``None`` is the card."""

    def __init__(self, dataset, transform: Transform, batch_size: int,
                 shuffle=True, drop_last=True, seed=0,
                 process_index: int = 0, process_count: int = 1,
                 device=None):
        self.dataset = dataset
        self.transform = transform
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        self.device = resolve_device(device)
        self._data = torch.from_numpy(np.ascontiguousarray(
            dataset.data)).to(self.device)
        self._labels = torch.from_numpy(np.asarray(
            dataset.labels, np.int32)).to(self.device)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.process_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        perm = _epoch_permutation(n, self.epoch, self.seed, self.shuffle)
        shard = perm[self.process_index::self.process_count]
        dup = self.transform.duplicates
        gen = epoch_generator(self.device, self.seed, self.epoch)
        # the epoch's order goes to the device once: a copy a batch from
        # pageable memory would make the host wait for the previous step
        shard = torch.from_numpy(np.asarray(shard, np.int64)).to(self.device)
        for b in range(len(self)):
            idx = shard[b * self.batch_size:(b + 1) * self.batch_size]
            if dup > 1:
                idx = idx.repeat_interleave(dup)
            x = self.transform.device(gen, self._data.index_select(0, idx))
            yield x, self._labels.index_select(0, idx)


class _StagingRing:
    """Host staging for the copies to the device: ``slots`` buffers used in
    turn, pinned for a CUDA device, where each is guarded by a CUDA event
    recorded after its non-blocking copies, so a buffer is refilled only
    once its last copies have finished. (A copy from pageable memory would
    make the host wait for the stream, the previous step included.)"""

    _ALIGN = 256

    def __init__(self, slots: int, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.buffers = [None] * slots
        self.events = [None] * slots
        self.next = 0

    def to_device(self, *arrays: np.ndarray):
        """Copies of the arrays on the device, in order; on the card the
        copies run on the current stream, after anything queued there."""
        i = self.next
        self.next = (i + 1) % len(self.buffers)
        if self.events[i] is not None:
            self.events[i].synchronize()
        offsets, total = [], 0
        for a in arrays:
            offsets.append(total)
            total += -(-a.nbytes // self._ALIGN) * self._ALIGN
        buf = self.buffers[i]
        if buf is None or buf.numel() < total:
            buf = torch.empty(total, dtype=torch.uint8, pin_memory=self.cuda)
            self.buffers[i] = buf
        out = []
        for a, o in zip(arrays, offsets):
            staged = buf[o:o + a.nbytes].view(
                torch.from_numpy(a[:0]).dtype).view(a.shape)
            np.copyto(staged.numpy(), a)
            out.append(staged.to(self.device, non_blocking=True, copy=True))
        if self.cuda:
            self.events[i] = torch.cuda.Event()
            self.events[i].record()
        return out


class DataLoader:
    """Threaded host pipeline for decode-heavy datasets. ``device``: where
    batches go and the device transform runs (``None`` is the card);
    ``device_transform=False`` yields the host batches, numpy uint8 images
    and int32 labels, without touching any device."""

    def __init__(self, dataset, transform: Transform, batch_size: int,
                 shuffle=True, drop_last=True, num_workers: int = 8, seed=0,
                 prefetch: int = 3, device_transform: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 device=None):
        self.dataset = dataset
        self.transform = transform
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.prefetch = prefetch
        self.device_transform = device_transform
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        self.device = resolve_device(device) if device_transform else None
        self.decoder = None   # which host decode the last epoch took

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.process_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load_sample(self, args):
        idx, sample_seed, dup = args
        sample, label = self.dataset[idx]
        return self.transform.host(sample, random.Random(sample_seed), dup), label

    def _decode_blob(self, args):
        blob, label, sample_seed, dup = args
        arr = self.transform.host(self.dataset.decode(blob),
                                  random.Random(sample_seed), dup)
        return arr, label

    def _choose_decoder(self, dup):
        """("tar" | "files" | None, why): the native path this epoch takes,
        as the reference chooses it."""
        from convnet_tpu_torch.data import native
        spec = getattr(self.transform, "native_spec", None)
        if spec is None:
            return None, "the host transform has no native form"
        if os.environ.get("CONVNET_TPU_NATIVE_DECODE", "1") == "0":
            return None, "CONVNET_TPU_NATIVE_DECODE=0"
        if dup > 1 and spec["kind"] != "rrc":
            return None, "eval duplicates stay on PIL"
        if hasattr(self.dataset, "tar_path") and hasattr(self.dataset,
                                                          "offsets"):
            kind = "tar"
        elif hasattr(self.dataset, "samples"):
            # an ImageFolder: native only where it is mostly JPEG (probed
            # evenly over the class-sorted listing, so the choice is stable
            # across epochs and processes); the odd png/bmp takes the
            # per-sample PIL repair
            n_samp = len(self.dataset.samples)
            probe_idx = np.unique(np.linspace(
                0, n_samp - 1, num=min(16, n_samp)).astype(int))
            probe = [self.dataset.samples[int(i)][0].lower()
                     for i in probe_idx]
            if not (len(probe) > 0 and sum(
                    p.endswith((".jpg", ".jpeg")) for p in probe)
                    >= max(1, len(probe) * 3 // 4)):
                return None, "the folder is not mostly JPEG"
            kind = "files"
        else:
            return None, "the dataset holds decoded arrays"
        if not native.jpeg_available():
            return None, native.jpeg_status().removeprefix("PIL: ")
        return kind, "native"

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        perm = _epoch_permutation(n, self.epoch, self.seed, self.shuffle)
        shard = perm[self.process_index::self.process_count]
        num_batches = len(self)
        dup = self.transform.duplicates
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        # workers=0 is the reference DataLoader's synchronous mode: one
        # thread, no fan-out
        pool = ThreadPoolExecutor(max_workers=max(1, self.num_workers))
        stop = threading.Event()

        def put(q, item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        # archive-backed datasets expose batched raw reads (native pread);
        # decode still fans out over the thread pool
        blob_mode = (hasattr(self.dataset, "read_blobs")
                     and hasattr(self.dataset, "decode"))
        native_kind, why = self._choose_decoder(dup)
        decoder = (f"native ({native_kind})" if native_kind
                   else f"PIL ({why})")
        if decoder != self.decoder:
            log.info("data loader: %s decode for %s", decoder,
                     type(self.dataset).__name__)
        self.decoder = decoder
        spec = self.transform.native_spec

        def native_kwargs(b):
            # process_index is in the seed: the C++ RNG keys per-sample
            # draws by batch-local position
            return dict(
                train=(spec["kind"] == "rrc"),
                out_size=spec["out_size"],
                scale_size=spec.get("scale_size", 0),
                seed=hash((self.seed, self.epoch, b, self.process_index))
                & (2 ** 63 - 1),
                scale=spec.get("scale", (0.08, 1.0)),
                ratio=spec.get("ratio", (3 / 4, 4 / 3)),
                duplicates=dup,
                fast_dct=os.environ.get("CONVNET_TPU_FAST_DCT", "0") == "1",
                threads=max(1, self.num_workers))

        def finish_native(idx, labels, decoded):
            """Both native paths' tail: the whole batch through PIL when the
            decode call failed, a PIL repair of each failed member, the
            labels' duplication."""
            ys = np.asarray(np.repeat(labels, dup), np.int32)
            if decoded is None:
                rows = []
                for i in idx:
                    sample, _ = self.dataset[int(i)]
                    rows.extend(self.transform.host(
                        sample, random.Random(_host_seed(
                            self.seed, self.epoch, i, d)), d)
                        for d in range(dup))
                return np.stack(rows), ys
            xs, fail = decoded
            for j in np.nonzero(fail)[0]:
                i = int(idx[int(j)])
                sample, _ = self.dataset[i]
                for d in range(dup):
                    xs[int(j) * dup + d] = self.transform.host(
                        sample, random.Random(_host_seed(
                            self.seed, self.epoch, i, d)), d)
            return xs, ys

        def native_batch(b, idx):
            from convnet_tpu_torch.data import native
            idx = np.asarray(idx, np.int64)
            decoded = native.decode_batch(
                self.dataset.tar_path,
                self.dataset.offsets[idx], self.dataset.sizes[idx],
                **native_kwargs(b))
            return finish_native(idx, self.dataset.labels[idx], decoded)

        def native_files_batch(b, idx):
            from convnet_tpu_torch.data import native
            idx = [int(i) for i in idx]
            labels = [self.dataset.samples[i][1] for i in idx]

            def read(i):
                with open(self.dataset.samples[i][0], "rb") as f:
                    return f.read()

            blobs = list(pool.map(read, idx))
            decoded = native.decode_blobs(blobs, **native_kwargs(b))
            return finish_native(idx, labels, decoded)

        # IO/decode overlap: a reader thread keeps raw-blob batches ahead of
        # the decoder
        blob_q: "queue.Queue" = queue.Queue(maxsize=2)

        def read_ahead():
            try:
                for b in range(num_batches):
                    if stop.is_set():
                        return
                    idx = shard[b * self.batch_size:(b + 1) * self.batch_size]
                    unique = list(dict.fromkeys(int(i) for i in idx))
                    put(blob_q, (idx, dict(zip(
                        unique, self.dataset.read_blobs(unique)))))
                put(blob_q, None)
            except Exception as e:
                put(blob_q, e)

        if blob_mode and native_kind is None:
            threading.Thread(target=read_ahead, daemon=True).start()

        def assemble():
            try:
                for b in range(num_batches):
                    if stop.is_set():
                        return
                    idx = shard[b * self.batch_size:(b + 1) * self.batch_size]
                    if native_kind is not None:
                        fn = (native_batch if native_kind == "tar"
                              else native_files_batch)
                        put(out_q, fn(b, idx))
                        continue
                    if blob_mode:
                        item = blob_q.get()
                        if isinstance(item, Exception):
                            raise item
                        idx, blobs = item
                        labels = self.dataset.labels
                        tasks = [
                            (blobs[int(i)], int(labels[int(i)]),
                             _host_seed(self.seed, self.epoch, i, d), d)
                            for i in idx for d in range(dup)]
                        results = list(pool.map(self._decode_blob, tasks))
                    else:
                        tasks = [
                            (int(i), _host_seed(self.seed, self.epoch, i, d),
                             d)
                            for i in idx for d in range(dup)]
                        results = list(pool.map(self._load_sample, tasks))
                    xs = np.stack([r[0] for r in results])
                    ys = np.asarray([r[1] for r in results], np.int32)
                    put(out_q, (xs, ys))
                put(out_q, None)
            except Exception as e:  # surface loader errors to the consumer
                put(out_q, e)

        thread = threading.Thread(target=assemble, daemon=True)
        thread.start()
        gen = ring = None
        if self.device_transform:
            gen = epoch_generator(self.device, self.seed, self.epoch)
            ring = _StagingRing(self.prefetch + 1, self.device)
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                xs, ys = item
                if self.device_transform:
                    x, y = ring.to_device(xs, ys)
                    yield self.transform.device(gen, x), y
                else:
                    yield xs, ys
        finally:
            stop.set()
            pool.shutdown(wait=False)
