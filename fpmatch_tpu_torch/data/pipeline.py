"""Pair construction + collation into fixed-shape PairBatch arrays, and the
loader that feeds them to the device: the counterpart of the JAX package's
`data/pipeline.py`.

  * per-sample work (image reading, standardize, Delaunay, label
    bookkeeping) happens on the host in worker threads or spawned worker
    processes; collation is bucket padding + stacking;
  * everything is driven by an explicit per-index RNG: sample i of epoch e is
    reproducible regardless of worker scheduling;
  * `DataLoader(device=..., device_prefetch=True)` on a CUDA device collates
    into pinned host memory and copies on a side stream, one batch ahead of
    the consumer.

A train split augments (`augment=True`, the default there): every pair's
two views go through `data.augmentation` with an RNG seeded from (seed,
epoch, index), as the JAX package's pipeline seeds it.

This module imports neither `torch` nor `cv2` at the top: spawned workers
import it and must never create a CUDA context.
"""
from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.build_graphs import (build_edges, delaunay_triangles,
                                 permute_edges)
from ..core.config import Config
from .augmentation import (augment_image_pair, augment_two_images,
                           standardize)
from .benchmark import Benchmark


def _load_image(path: str) -> np.ndarray:
    """Read an image file as (H, W, 3) uint8 RGB."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _annos_of(entry_kpts) -> List[List]:
    return [[k["labels"], k["x"], k["y"]] for k in entry_kpts]


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) uint8 luma, with OpenCV's 8-bit
    fixed-point RGB2GRAY arithmetic (15-bit coefficients of 0.299 / 0.587 /
    0.114, round to nearest), so collation needs no cv2."""
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + 16384) >> 15).astype(np.uint8)


@dataclass
class PairSample:
    """One matching problem in host (numpy, ragged) form."""

    images: Tuple[np.ndarray, np.ndarray]      # (H, W, 3) uint8 RGB x2
    points: Tuple[np.ndarray, np.ndarray]      # (n_i, 2) float32
    edges: Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]
    perm: np.ndarray                           # (n1, n2)
    label: float
    cls: Tuple[str, str]
    tris: Optional[Tuple[np.ndarray, np.ndarray]] = None


class PairDataset:
    """Index-addressable pair source over a Benchmark (match or classify)."""

    def __init__(self, bench: Benchmark, cfg: Config, *,
                 augment: Optional[bool] = None, length: Optional[int] = None,
                 seed: int = 123):
        self.bench = bench
        self.cfg = cfg
        self.seed = seed
        self.augment = (bench.sets == "train") if augment is None else augment
        if bench.task == "classify":
            self.pairs = bench.classify_pairs()
        else:
            self.pairs = bench.match_combinations()
        if length is not None and bench.sets != "test":
            # seeded shuffle first: the pair list is genuine-then-imposter,
            # so an ordered truncation would keep genuine pairs only
            import random as _random
            _random.Random(seed * 99_991 + 7).shuffle(self.pairs)
            self.pairs = self.pairs[:length]

    def __len__(self):
        return len(self.pairs)

    # ------------------------------------------------------------------
    def _clip_common(self, ann1, ann2, n_max):
        """Keep at most n_max shared labels, preserving view-1 order in both
        views so the identity assignment stays valid."""
        common = [a[0] for a in ann1 if a[0] in {b[0] for b in ann2}]
        keep = set(common[:n_max])
        a1 = [a for a in ann1 if a[0] in keep]
        order = {lab: i for i, lab in enumerate(a[0] for a in a1)}
        a2 = sorted((b for b in ann2 if b[0] in keep),
                    key=lambda b: order[b[0]])
        return a1, a2

    def get(self, idx: int, epoch: int = 0) -> PairSample:
        """Sample `idx` (wrapping modulo the pair count) of `epoch`; the
        augmentation RNG is seeded from (seed, epoch, idx)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + epoch) * 2_000_003 + idx)
        pair = self.pairs[idx % len(self.pairs)]
        cfg = self.cfg
        n_max = cfg.shapes.n_max
        genuine = self.bench.is_genuine(*pair)
        e1 = self.bench.data_dict[pair[0]]
        e2 = self.bench.data_dict[pair[1]]

        if genuine and pair[0] == pair[1]:
            img = _load_image(e1["path"])
            annos = _annos_of(e1["kpts"])
            if self.augment:
                (i1, a1), (i2, a2) = augment_image_pair(
                    img, annos, rng,
                    min_points=cfg.data.augment_min_points,
                    min_common=cfg.data.augment_min_common,
                    max_attempts=cfg.data.augment_max_attempts)
            else:
                i1, a1 = standardize(img, annos)
                i2, a2 = standardize(img, annos)
            a1, a2 = self._clip_common(a1, a2, n_max)
            n = min(len(a1), len(a2))
            perm = np.eye(n, dtype=np.float32)
            label = 1.0
        else:
            img1, img2 = _load_image(e1["path"]), _load_image(e2["path"])
            an1, an2 = _annos_of(e1["kpts"]), _annos_of(e2["kpts"])
            if self.augment:
                (i1, a1), (i2, a2) = augment_two_images(
                    img1, an1, img2, an2, rng,
                    min_points=cfg.data.augment_min_points)
            else:
                i1, a1 = standardize(img1, an1)
                i2, a2 = standardize(img2, an2)
            a1 = a1[:n_max]
            a2 = a2[:n_max]
            perm = np.zeros((len(a1), len(a2)), np.float32)
            if genuine:
                # cross-impression genuine (session protocol / match task):
                # identity is by keypoint label equality
                lab2 = {lab: j for j, (lab, _, _) in enumerate(a2)}
                for i, (lab, _, _) in enumerate(a1):
                    j = lab2.get(lab)
                    if j is not None:
                        perm[i, j] = 1
            label = 1.0 if genuine else 0.0

        P1 = np.array([[x, y] for _, x, y in a1], np.float32).reshape(-1, 2)
        P2 = np.array([[x, y] for _, x, y in a2], np.float32).reshape(-1, 2)

        stg = cfg.data.src_graph_construct
        _, s1, d1 = build_edges(P1, stg=stg)
        # G2 = P^T G1 is only well-defined for a COMPLETE permutation (every
        # source node matched); partial-overlap pairs (cross-impression
        # genuine) get an independent Delaunay on P2
        complete = (perm.shape[0] == perm.shape[1]
                    and perm.sum() == perm.shape[0] > 0)
        if cfg.data.tgt_graph_construct == "same" and complete:
            s2, d2 = permute_edges(s1, d1, perm)       # G2 = P^T G1
        else:
            _, s2, d2 = build_edges(P2, stg=stg)
        e_max = cfg.shapes.e_max
        s1, d1 = s1[:e_max], d1[:e_max]
        s2, d2 = s2[:e_max], d2[:e_max]

        tris = None
        if cfg.ngm.hyperedge:
            t_max = cfg.shapes.t_max
            tris = (delaunay_triangles(P1)[:t_max],
                    delaunay_triangles(P2)[:t_max])

        return PairSample(images=(i1, i2), points=(P1, P2),
                          edges=((s1, d1), (s2, d2)), perm=perm,
                          label=label, cls=(e1["cls"], e2["cls"]),
                          tris=tris)


# ------------------------------------------------------------ process workers
#
# Python threads share the GIL: the per-pair host work holds it often enough
# that a thread pool tops out near one core. Worker PROCESSES sidestep it.
# Spawn (not fork), so children never inherit the parent's CUDA context;
# every module a worker imports is torch-free at import time (numpy / cv2 /
# scipy only).

_WORKER_DATASET: Optional["PairDataset"] = None


def _init_worker(dataset: "PairDataset") -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_get(idx: int, epoch: int) -> "PairSample":
    return _WORKER_DATASET.get(idx, epoch)


# ---------------------------------------------------------------- collation

def _pinned_zeros(shape, dtype) -> np.ndarray:
    """A zeroed numpy array whose memory is page-locked (it is a view of a
    pinned torch tensor, which it keeps alive), so a non-blocking copy to the
    device can run beside the host."""
    import torch

    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    return torch.zeros(tuple(shape), dtype=tdtype, pin_memory=True).numpy()


def collate(samples: Sequence[PairSample], cfg: Config, pinned: bool = False):
    """Pad + stack host samples into a PairBatch of numpy arrays. Images
    stay raw uint8 and unnormalized (the model normalizes on the device);
    with `cfg.data.image_channels == 1` only the luma is shipped. With
    `pinned` the arrays live in page-locked memory (needs a CUDA build of
    torch; only the loader's prefetch path asks for it)."""
    from ..models.ngm import PairBatch

    B = len(samples)
    N, E = cfg.shapes.n_max, cfg.shapes.e_max
    H, W = cfg.data.rescale[1], cfg.data.rescale[0]
    C = cfg.data.image_channels

    zeros = _pinned_zeros if pinned else np.zeros
    images = zeros((B, 2, H, W, C), np.uint8)
    points = zeros((B, 2, N, 2), np.float32)
    src = zeros((B, 2, E), np.int32)
    dst = zeros((B, 2, E), np.int32)
    n_nodes = zeros((B, 2), np.int32)
    n_edges = zeros((B, 2), np.int32)
    gt_perm = zeros((B, N, N), np.float32)
    label = zeros((B,), np.float32)
    gt_k = zeros((B,), np.float32)
    hyper = cfg.ngm.hyperedge
    if hyper:
        tri = zeros((B, 2, cfg.shapes.t_max, 3), np.int32)
        n_tris = zeros((B, 2), np.int32)

    for b, s in enumerate(samples):
        for v in range(2):
            img = s.images[v]
            if C == 1 and img.ndim == 3 and img.shape[2] == 3:
                img = rgb_to_gray(img)
            if img.ndim == 2:
                img = img[..., None]
            images[b, v, :img.shape[0], :img.shape[1]] = img[:H, :W]
            P = s.points[v][:N]
            points[b, v, :len(P)] = P
            n_nodes[b, v] = len(P)
            sv, dv = s.edges[v]
            src[b, v, :len(sv)] = sv
            dst[b, v, :len(dv)] = dv
            n_edges[b, v] = len(sv)
            if hyper and s.tris is not None:
                tv = s.tris[v]
                tri[b, v, :len(tv)] = tv
                n_tris[b, v] = len(tv)
        p = s.perm[:N, :N]
        gt_perm[b, :p.shape[0], :p.shape[1]] = p
        label[b] = s.label
    gt_k[:] = gt_perm.sum((1, 2))

    batch = PairBatch(images, points, n_nodes, src, dst, n_edges, gt_perm,
                      label, gt_k)
    if hyper:
        batch = batch._replace(tri=tri, n_tris=n_tris)
    return batch


class DataLoader:
    """Seed-deterministic prefetching loader.

    :param device: where batches go. None (default) yields host PairBatches
        of numpy arrays; a device yields PairBatches of tensors there.
    :param device_prefetch: copy batch k+1 to `device` while the consumer
        works on batch k. On a CUDA device each batch is collated into pinned
        host memory and copied with `non_blocking=True` on a side stream that
        the loader owns; an event recorded after the copies is what the
        consumer's current stream waits on before the batch is handed out
        (`wait_event`: an explicit event orders the copy before the first
        kernel that reads the batch), and `record_stream` tells the caching
        allocator that the consumer's stream uses memory allocated on the
        side stream. The pinned arrays of a batch are held until its event
        has been waited on. On the CPU the flag changes nothing: the batch
        is converted when it is asked for.
    :param cache: keep the samples (and, with `device_prefetch`, the device
        batches) of the first pass; only sound when the output does not
        depend on the epoch (no shuffle, no augmentation).
    :param host_batch_hook: host-side batch decoration before transfer
        (e.g. the row plan of the edge-sharded path).
    :param shard: (d, D): yield slice d of D of every batch (the rank's
        part of the global batch under a rank grid; `batch_size` stays the
        global one and must be divisible by D). Only that slice's samples
        are loaded, so the slice is taken before collation and the pinned /
        side-stream copy.
    """

    def __init__(self, dataset: PairDataset, cfg: Config, *,
                 batch_size: Optional[int] = None, shuffle: bool = False,
                 num_workers: Optional[int] = None, drop_last: bool = True,
                 use_processes: Optional[bool] = None, cache: bool = False,
                 device=None, device_prefetch: bool = False,
                 host_batch_hook=None, shard: Optional[tuple] = None):
        self.dataset = dataset
        self.cfg = cfg
        self.host_batch_hook = host_batch_hook
        self.batch_size = batch_size or cfg.data.batch_size
        if shard is not None and self.batch_size % shard[1]:
            raise ValueError(f"batch size {self.batch_size} not divisible "
                             f"by data axis {shard[1]}")
        self.shard = shard
        self.shuffle = shuffle
        self.num_workers = (cfg.data.num_workers if num_workers is None
                            else num_workers)
        self.drop_last = drop_last
        self.use_processes = (cfg.data.worker_processes
                              if use_processes is None else use_processes)
        self.cache = cache and not shuffle and not dataset.augment
        self._cached: Optional[Dict[int, PairSample]] = None
        if device_prefetch and device is None:
            raise ValueError("device_prefetch needs a device")
        self.device = device
        self.device_prefetch = device_prefetch
        self._dev_cached: Optional[List] = None
        self._executor = None
        self._copy_stream = None
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _on_cuda(self) -> bool:
        if self.device is None:
            return False
        import torch

        return torch.device(self.device).type == "cuda"

    def __iter__(self) -> Iterator:
        if self._dev_cached is not None:
            yield from self._dev_cached
            return
        prefetch = self.device_prefetch and self._on_cuda()
        host_iter = self._host_iter(pinned=prefetch)
        if self.host_batch_hook is not None:
            host_iter = map(self.host_batch_hook, host_iter)
        if self.device is None:
            yield from host_iter
            return
        if not prefetch:
            dev_iter = (b.to(self.device) for b in host_iter)
        else:
            dev_iter = self._prefetch_iter(host_iter)
        keep = [] if (self.cache and self.device_prefetch) else None
        for b in dev_iter:
            if keep is not None:
                keep.append(b)
            yield b
        if keep is not None:
            self._dev_cached = keep

    # ------------------------------------------------------ CUDA prefetch
    def _enqueue(self, host_batch):
        """Start the copy of one pinned host batch on the side stream.
        Returns (device batch, event after its copies, the host batch)."""
        import torch

        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)

        def put(a):
            if isinstance(a, tuple):            # a row plan's arrays
                return type(a)(*(put(x) for x in a))
            if not isinstance(a, np.ndarray):
                return a
            t = torch.from_numpy(a)
            if not t.is_pinned():
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        with torch.cuda.stream(self._copy_stream):
            dev_batch = type(host_batch)(*(put(a) for a in host_batch))
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return dev_batch, done, host_batch

    def _hand_out(self, pending):
        import torch

        dev_batch, done, _host_batch = pending
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(done)
        for t in dev_batch:
            for u in (t if isinstance(t, tuple) else (t,)):
                if isinstance(u, torch.Tensor):
                    u.record_stream(consumer)
        return dev_batch

    def _prefetch_iter(self, host_iter) -> Iterator:
        pending = None
        for host_batch in host_iter:
            nxt = self._enqueue(host_batch)
            if pending is not None:
                yield self._hand_out(pending)
            pending = nxt
        if pending is not None:
            yield self._hand_out(pending)

    # --------------------------------------------------------- host side
    def _host_iter(self, pinned: bool = False) -> Iterator:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.cfg.data.random_seed
                                  + self.epoch).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.shard is not None:
            d, n = self.shard
            batches = [b[d * len(b) // n:(d + 1) * len(b) // n]
                       for b in batches]
        epoch = self.epoch
        self.epoch += 1

        if self.cache and self._cached is not None:
            for idxs in batches:
                yield collate([self._cached[int(i)] for i in idxs], self.cfg,
                              pinned)
            return

        filling = {} if self.cache else None
        for idxs, samples in zip(batches,
                                 self._sample_batches(batches, epoch)):
            if filling is not None:
                filling.update(zip((int(i) for i in idxs), samples))
            yield collate(samples, self.cfg, pinned)
        if filling is not None:
            # shuffle=False: every future epoch requests exactly these
            # indices
            self._cached = filling

    def _sample_batches(self, batches, epoch) -> Iterator[List[PairSample]]:
        if self.num_workers <= 1:
            for idxs in batches:
                yield [self.dataset.get(int(i), epoch) for i in idxs]
            return
        pool = self._pool()
        get = _worker_get if self.use_processes else self.dataset.get
        pending = []
        for idxs in batches:
            pending.append([pool.submit(get, int(i), epoch) for i in idxs])
            while len(pending) > 2:          # keep ~2 batches in flight
                yield [f.result() for f in pending.pop(0)]
        for futs in pending:
            yield [f.result() for f in futs]

    def _pool(self):
        # one long-lived pool per loader: no per-epoch churn
        if self._executor is None:
            if self.use_processes:
                ctx = multiprocessing.get_context("spawn")
                self._executor = ProcessPoolExecutor(
                    max_workers=self.num_workers, mp_context=ctx,
                    initializer=_init_worker, initargs=(self.dataset,))
            else:
                self._executor = ThreadPoolExecutor(
                    max_workers=self.num_workers)
        return self._executor

    def close(self) -> None:
        """Stop the worker pool (threads or processes), if one was started."""
        if self._executor is not None:
            self._executor.shutdown(wait=True, cancel_futures=True)
            self._executor = None
