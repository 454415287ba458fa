"""Loop closure: retrieval, batched candidate registration, verification.

Port of ``tbv_slam_public_tpu.models.loopclosure`` (ScanContextClosure,
loopclosure.cpp:593-745): per-keyframe contexts (RSC descriptors of the
aggregated local map and its lateral augmentations), odometry-coupled
retrieval merged across augmentations, P2L registration of every (query,
candidate) pair from the ScanContext guess, CorAl + CFEAR verification
features, the logistic loop verifier, and per-query acceptance.  Two
schedules share these stages: the offline wave over all keyframes
(``process_all_batched``) and the online per-keyframe form
(``process_pending`` / ``finish``), whose k candidates of one query go
through the pair form with the query broadcast.

The reference pads keyframe stores and waves to universal shapes so its
compiled programs are cached; eager PyTorch needs no such padding, so waves
are exactly as large as the work.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import se2
from ..core.config import TBVConfig
from ..core.device import resolve
from ..core.timing import timing
from ..core.types import Cells, PointCloud, stack_records
from ..kernels import refmath
from ..ops import logistic, scancontext
from ..ops import registration as reg_op
from ..parallel import multihost
from ..parallel import retrieval as par_ret
from . import verification as verif


@dataclass
class LoopDB:
    """Descriptor database + odometry poses, padded to a capacity.  A
    database sharded over a mesh (``parallel.retrieval.shard_db``) holds the
    descriptor rows of slots ``lo .. lo + desc.shape[0]`` only."""

    desc: torch.Tensor  # [N, R, S] (sharded: [N / D, R, S])
    ring: torch.Tensor  # [N, R] (sharded: [N / D, R])
    odom_pose: torch.Tensor  # [N, 3] odometry (un-optimized) keyframe poses
    mask: torch.Tensor  # [N] bool
    lo: int = 0  # global slot of desc[0]


def make_db(capacity: int, cfg: TBVConfig, device=None) -> LoopDB:
    sc = cfg.scancontext
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return LoopDB(desc=z(capacity, sc.num_ring, sc.num_sector),
                  ring=z(capacity, sc.num_ring), odom_pose=z(capacity, 3),
                  mask=torch.zeros(capacity, dtype=torch.bool, device=device))


def grow_db(db: LoopDB, new_capacity: int) -> LoopDB:
    if db.desc.shape[0] != db.mask.shape[0]:
        raise ValueError("grow the whole database: unshard it first")
    pad = new_capacity - db.mask.shape[0]
    g = lambda x: torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    return LoopDB(g(db.desc), g(db.ring), g(db.odom_pose), g(db.mask))


def db_insert_batch(db: LoopDB, slots: torch.Tensor, descs: torch.Tensor,
                    rings: torch.Tensor, odom: torch.Tensor) -> LoopDB:
    """Write a batch of keyframe descriptors into the DB (in place); a
    sharded DB keeps the descriptors of its own slots."""
    db.odom_pose[slots] = odom
    db.mask[slots] = True
    if db.desc.shape[0] != db.mask.shape[0]:
        own = (slots >= db.lo) & (slots < db.lo + db.desc.shape[0])
        slots, descs, rings = slots[own] - db.lo, descs[own], rings[own]
    db.desc[slots] = descs
    db.ring[slots] = rings
    return db


def db_insert(db: LoopDB, slot: int, desc: torch.Tensor, ring: torch.Tensor,
              odom_pose: torch.Tensor) -> LoopDB:
    """Write one keyframe's descriptor into the DB (in place); a sharded DB
    keeps the descriptor only if the slot is its own."""
    if db.lo <= slot < db.lo + db.desc.shape[0]:
        db.desc[slot - db.lo] = desc
        db.ring[slot - db.lo] = ring
    db.odom_pose[slot] = odom_pose
    db.mask[slot] = True
    return db


def augmentation_offsets(cfg: TBVConfig, device=None) -> torch.Tensor:
    """[A, 3] Taug: identity plus the lateral (y) augmentation shifts."""
    sc = cfg.scancontext
    offsets = [0.0] + (list(sc.augment_offsets) if sc.augment_sc else [])
    return torch.tensor([[0.0, o, 0.0] for o in offsets], dtype=torch.float32,
                        device=device)


def context_descriptors(local_map: PointCloud, cfg: TBVConfig):
    """Descriptors of local maps [B, L] and their lateral augmentations:
    (descs [B, A, R, S], rings [B, A, R]); row 0 is the unshifted query."""
    taug = augmentation_offsets(cfg, local_map.xy.device)
    shifted = PointCloud(
        xy=local_map.xy[:, None] + taug[None, :, None, :2],
        intensity=local_map.intensity[:, None].expand(-1, taug.shape[0], -1),
        mask=local_map.mask[:, None].expand(-1, taug.shape[0], -1))
    d = scancontext.make_descriptor(shifted, cfg.scancontext)
    return d, scancontext.ring_key(d)


def _local_map(k, query, pose, xy):
    """A window keyframe's peak moved into the query keyframe's frame:
    se2.relative(query, pose), then se2.apply (recomputed for each point on
    the card: the same arithmetic, so the same bits)."""
    return k.site("apply", k.site("relative", query, pose), xy)


def _loop_guess(k, taug, yaw):
    """The loop registration's guess Taug^-1 * R(yaw) (ScanContext's
    alignment)."""
    rot = k.stack([k.zeros_like(yaw), k.zeros_like(yaw), yaw])
    return k.site("compose", k.site("inverse", taug), rot)


refmath.register_chain("local_map", [(_local_map, range(3))],
                       ((3,), (3,), (2,)))
refmath.register_chain("loop_guess", [(_loop_guess, range(2))], ((3,), ()))


def build_contexts_batched(store_peaks: PointCloud, store_odom: torch.Tensor,
                           q_idx: torch.Tensor, n_total: int,
                           cfg: TBVConfig):
    """Local-map aggregation + descriptors for a batch of keyframes: the
    +-n_aggregate window of each query expressed in its frame (ScansToLocalMap),
    its ``local_map_capacity`` strongest points, then the descriptors.
    Returns (descs [B, A, R, S], rings [B, A, R])."""
    n_agg = cfg.loopclosure.n_aggregate
    p = store_peaks.xy.shape[1]
    cap = min(cfg.loopclosure.local_map_capacity, (2 * n_agg + 1) * p)
    dev = store_odom.device
    idxs = q_idx[:, None] + torch.arange(-n_agg, n_agg + 1, device=dev)
    kf_ok = (idxs >= 0) & (idxs < n_total)
    idxs = torch.clamp(idxs, 0, n_total - 1)
    bsz = q_idx.shape[0]
    # each window keyframe's pose in the query's frame and its peaks moved
    # by it, one chain (one launch on the card)
    xy = refmath.chain("local_map", store_odom[q_idx][:, None, None],
                       store_odom[idxs][:, :, None],
                       store_peaks.xy[idxs]).reshape(bsz, -1, 2)
    inten = store_peaks.intensity[idxs].reshape(bsz, -1)
    mask = (store_peaks.mask[idxs] & kf_ok[..., None]).reshape(bsz, -1)
    score = torch.where(mask, inten, torch.full_like(inten, -1.0))
    top = torch.sort(score, dim=-1, descending=True, stable=True)[1][:, :cap]
    local = PointCloud(
        xy=torch.gather(xy, 1, top[..., None].expand(-1, -1, 2)),
        intensity=torch.gather(inten, 1, top),
        mask=torch.gather(mask, 1, top) & (torch.gather(score, 1, top) >= 0))
    return context_descriptors(local, cfg)


@dataclass
class DetectResult:
    index: torch.Tensor  # [B, K] db index of candidate ("to")
    aug: torch.Tensor  # [B, K] augmentation that produced it
    dist: torch.Tensor  # [B, K] combined score (sc + odom)
    dist_sc: torch.Tensor
    dist_odom: torch.Tensor
    yaw: torch.Tensor  # [B, K] SC yaw alignment (radians)
    valid: torch.Tensor  # [B, K] bool


def detect(db: LoopDB, descs: torch.Tensor, rings: torch.Tensor,
           cur_slot: torch.Tensor, cfg: TBVConfig, mesh=None) -> DetectResult:
    """Candidate retrieval for the keyframes at ``cur_slot`` [B]
    (detectLoopClosureID): odometry similarity over history, dynamic
    recent-exclusion, per-augmentation retrieval, merged and deduplicated by
    database index, best ``n_candidates`` by combined score.

    ``mesh``: an optional ``parallel.multihost.Mesh`` over which the
    database's keyframe axis is sharded; with more than one rank retrieval
    is a local top-k and a gathered merge
    (``parallel.retrieval.sharded_retrieve``), equal to the single-device
    result."""
    sc = cfg.scancontext
    dev = descs.device
    n = db.mask.shape[0]
    idxs = torch.arange(n, device=dev)
    cur = cur_slot[:, None]
    hist = db.mask[None] & (idxs[None] <= cur)  # [B, N]
    odom_sim = scancontext.odometry_similarity(db.odom_pose[:, :2], hist,
                                               sc.odom_sigma_error)
    n_excl = scancontext.num_exclude_recent(db.odom_pose[:, :2], hist,
                                            sc.distance_exclude_recent)
    search = hist & (idxs[None] < cur - n_excl[:, None] + 1) & \
        (idxs[None] < cur)
    retrieve = scancontext.retrieve
    if mesh is not None and mesh.size > 1:
        retrieve = functools.partial(par_ret.sharded_retrieve, mesh)
    r = retrieve(
        descs, rings, db.desc, db.ring, search[:, None], odom_sim[:, None],
        num_candidates=sc.num_candidates_from_tree,
        search_ratio=sc.search_ratio,
        odometry_coupled=sc.odometry_coupled_closure)
    bsz, a, k0 = r.dist.shape
    flat = lambda x: x.reshape(bsz, a * k0)
    dist, dist_sc, dist_odom = flat(r.dist), flat(r.dist_sc), flat(r.dist_odom)
    index, shift, valid = flat(r.index), flat(r.shift), flat(r.valid)
    aug = torch.arange(a, device=dev)[:, None].expand(a, k0).reshape(-1)
    inf = torch.full((), float("inf"), device=dev)

    # sort by combined score; drop duplicate db indices (keep the best)
    score = torch.where(valid, dist, inf)
    order = torch.sort(score, dim=-1, stable=True)[1]
    s_idx = torch.gather(index, 1, order)
    s_score = torch.gather(score, 1, order)
    dup = torch.triu(s_idx[:, None, :] == s_idx[:, :, None], diagonal=1)
    s_score = torch.where(dup.any(1), inf, s_score)
    reorder = torch.sort(s_score, dim=-1, stable=True)[1][:, :sc.n_candidates]
    pick = torch.gather(order, 1, reorder)
    take = lambda x: torch.gather(x, 1, pick)
    kdist = torch.where(torch.isfinite(torch.gather(s_score, 1, reorder)),
                        take(dist), inf)
    ok = torch.isfinite(kdist)
    if cfg.loopclosure.speedup and sc.odometry_coupled_closure:
        # odometry-implausible candidates skip registration entirely
        ok = ok & (take(dist_odom) <= 0.7)
    return DetectResult(index=take(index), aug=aug[pick], dist=kdist,
                        dist_sc=take(dist_sc), dist_odom=take(dist_odom),
                        yaw=scancontext.shift_to_yaw(take(shift),
                                                     sc.num_sector),
                        valid=ok)


@dataclass
class CandidateResult:
    t_be: torch.Tensor  # [M, 3] registered relative pose from -> to
    prob: torch.Tensor  # [M] verification probability
    sc_sim: torch.Tensor  # [M]
    odom_bounds: torch.Tensor  # [M]
    align_quality: torch.Tensor  # [M]
    x6: torch.Tensor  # [M, 6] raw alignment features
    reg_score: torch.Tensor  # [M]
    reg_ok: torch.Tensor  # [M] bool
    valid: torch.Tensor  # [M] bool
    cov: torch.Tensor  # [M, 3, 3] sampled registration covariance
    cov_ok: torch.Tensor  # [M] bool


def _loop_registration_cfg(cfg: TBVConfig):
    lc = cfg.loopclosure
    return dataclasses.replace(
        cfg.registration, cost="P2L",
        max_outer_iterations=lc.registration_max_outer,
        min_outer_iterations=1,
        max_inner_iterations=lc.registration_max_inner)


def _pair_register_verify(q_cells, q_peaks, c_cells, c_peaks, taug, yaw,
                          align_model, cfg: TBVConfig):
    """M (query, candidate) pairs: P2L registration from the ScanContext
    guess Taug^-1 * R(yaw), the loop constraint t_be, the sampled covariance
    at the optimum and the CorAl + CFEAR features at t_be."""
    loop_rcfg = _loop_registration_cfg(cfg)
    m = yaw.shape[0]
    dev = yaw.device
    zeros = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    guess = refmath.chain("loop_guess", taug, yaw)
    tgt = c_cells.map(lambda x: x[:, None])
    one = torch.ones((m, 1), dtype=torch.bool, device=dev)
    res = reg_op.register_window(q_cells, zeros, tgt, guess[:, None], one,
                                 loop_rcfg)
    t_be = se2.relative(res.pose, guess)
    cov, cov_ok = reg_op.sampled_covariance(
        q_cells, res.pose, tgt, guess[:, None], one, loop_rcfg, res.score,
        res.num_residuals)
    x6 = verif.alignment_features(q_peaks, q_cells, zeros, c_peaks, c_cells,
                                  t_be, cfg.verification)
    align_q = logistic.predict_linear(align_model, x6)
    return t_be, res.score, res.success, align_q, x6, cov, cov_ok


def register_and_verify_pairs(q_cells: Cells, q_peaks: PointCloud,
                              c_cells: Cells, c_peaks: PointCloud,
                              taug: torch.Tensor, yaw: torch.Tensor,
                              sc_sim: torch.Tensor, odom_bounds: torch.Tensor,
                              pair_valid: torch.Tensor,
                              align_model: logistic.LogisticModel,
                              loop_model: logistic.LogisticModel,
                              cfg: TBVConfig) -> CandidateResult:
    """Flat batched loop-pair registration + verification; every row has its
    own query (the offline wave form)."""
    t_be, score, reg_ok, align_q, x6, cov, cov_ok = _pair_register_verify(
        q_cells, q_peaks, c_cells, c_peaks, taug, yaw, align_model, cfg)
    prob = logistic.predict_proba(
        loop_model, torch.stack([odom_bounds, sc_sim, align_q], -1))
    ok = pair_valid & reg_ok
    return CandidateResult(
        t_be=t_be, prob=torch.where(ok, prob, torch.zeros_like(prob)),
        sc_sim=sc_sim, odom_bounds=odom_bounds, align_quality=align_q, x6=x6,
        reg_score=score, reg_ok=reg_ok, valid=ok, cov=cov, cov_ok=cov_ok)


def register_and_verify(q_cells: Cells, q_peaks: PointCloud,
                        c_cells: Cells, c_peaks: PointCloud,
                        taug: torch.Tensor, yaw: torch.Tensor,
                        sc_sim: torch.Tensor, odom_bounds: torch.Tensor,
                        cand_valid: torch.Tensor,
                        align_model: logistic.LogisticModel,
                        loop_model: logistic.LogisticModel,
                        cfg: TBVConfig) -> CandidateResult:
    """The K candidates [K, ...] of ONE query (the online form,
    RegisterLoopCandidate): the query is broadcast over the candidates and
    the batch goes through the pair form."""
    k = yaw.shape[0]
    rep = lambda x: x[None].expand((k,) + x.shape)
    return register_and_verify_pairs(
        q_cells.map(rep), q_peaks.map(rep), c_cells, c_peaks, taug, yaw,
        sc_sim, odom_bounds, cand_valid, align_model, loop_model, cfg)


@dataclass
class LoopConstraint:
    id_from: int
    id_to: int
    t_be: np.ndarray  # [3]
    prob: float
    quality: Dict[str, float] = field(default_factory=dict)
    cov: Optional[np.ndarray] = None  # [3, 3]; None if the fit was not convex


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _fetch(rec) -> Dict[str, np.ndarray]:
    """All fields of a record of [M, ...] tensors as host arrays, through ONE
    device->host copy: the fields are packed row-wise into a float32 buffer
    (indices stay exact below 2^24) and restored to their shapes and types."""
    fields = [(f.name, getattr(rec, f.name)) for f in dataclasses.fields(rec)]
    m = fields[0][1].shape[0]
    flat = torch.cat([x.reshape(m, -1).to(torch.float32) for _, x in fields],
                     1).cpu().numpy()
    out, lo = {}, 0
    for name, x in fields:
        width = int(np.prod(x.shape[1:]))
        a = flat[:, lo:lo + width].reshape(tuple(x.shape))
        lo += width
        if x.dtype == torch.bool:
            a = a > 0.5
        elif not x.dtype.is_floating_point:
            a = a.astype(np.int64)
        out[name] = a
    return out


class LoopCloser:
    """Host-side loop-closure driver (the ScanContextClosure strategy).

    Keeps per-keyframe peaks/cells as host arrays, stacks them on ``device``
    for the waves, and emits accepted LoopConstraint records;
    ``candidate_log`` records every evaluated candidate (loop.csv).

    ``mesh``: an optional ``parallel.multihost.Mesh``.  With more than one
    rank the descriptor database is sharded over it, retrieval is the
    sharded form, and every pair wave (or one query's candidates) is split
    over its ranks (``parallel.candidates``); rank 0's detection result
    sets the waves of every rank.  Every rank returns the same constraints.
    The device defaults to the mesh's."""

    def __init__(self, cfg: TBVConfig, device=None,
                 align_model: Optional[logistic.LogisticModel] = None,
                 loop_model: Optional[logistic.LogisticModel] = None,
                 mesh: Optional[multihost.Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        # the mesh that the sharded paths run over: one of more than a rank
        self._shard = mesh if mesh is not None and mesh.size > 1 else None
        self._size = 1 if self._shard is None else self._shard.size
        self.device = resolve(device if device is not None or mesh is None
                              else mesh.device)
        self.align_model = (align_model or logistic.from_values(
            cfg.verification.alignment_coefs[0],
            cfg.verification.alignment_coefs[1:])).to(self.device)
        self.loop_model = (loop_model or verif.default_loop_model(
            cfg.verification)).to(self.device)
        self.db = make_db(self._db_chunk(), cfg, self.device)
        if self._shard is not None:
            self.db = par_ret.shard_db(self._shard, self.db)
        self.kf_peaks: List[PointCloud] = []
        self.kf_cells: List[Cells] = []
        self.kf_odom: List[np.ndarray] = []
        self.constraints: List[LoopConstraint] = []
        self.candidate_log: List[dict] = []
        self._processed = 0
        self._store = None
        self._on_device: Dict[int, tuple] = {}  # keyframe -> (cells, peaks)

    def add_keyframe(self, peaks: PointCloud, cells: Cells,
                     odom_pose: np.ndarray) -> None:
        """Store a keyframe's payload on the host.  Peaks clouds are padded
        to the k-strongest capacity but sparse: keep the strongest
        ``peaks_capacity`` (the same host selection as the reference, so both
        packages hand identical clouds to verification)."""
        peaks, cells = peaks.map(_host), cells.map(_host)
        cap = self.cfg.verification.peaks_capacity
        if peaks.xy.shape[-2] > cap:
            xy, inten, m = peaks.xy, peaks.intensity, peaks.mask
            n_valid = int(m.sum())
            if n_valid > cap:
                timing.document("peaks_capacity_dropped", n_valid - cap)
            score = np.where(m, inten, -1.0)
            idx = np.argpartition(-score, cap - 1)[:cap]
            peaks = PointCloud(xy=xy[idx], intensity=inten[idx],
                               mask=m[idx] & (score[idx] >= 0.0))
        self.kf_peaks.append(peaks)
        self.kf_cells.append(cells)
        self.kf_odom.append(np.asarray(odom_pose, np.float32))

    def _aggregate_local_map(self, q: int) -> PointCloud:
        """ScansToLocalMap: peaks of keyframes q-n..q+n in the frame of
        keyframe q, the strongest ``local_map_capacity`` of them, padded
        (host reference of the batched on-device aggregation)."""
        n_agg = self.cfg.loopclosure.n_aggregate
        cap = self.cfg.loopclosure.local_map_capacity
        center = self.kf_odom[q]
        xs, ins, ms = [], [], []
        for i in range(max(0, q - n_agg),
                       min(len(self.kf_odom) - 1, q + n_agg) + 1):
            pc = self.kf_peaks[i]
            xs.append(se2.apply_np(se2.relative_np(center, self.kf_odom[i]),
                                   pc.xy))
            ins.append(pc.intensity)
            ms.append(pc.mask)
        xy, inten, mask = np.concatenate(xs), np.concatenate(ins), \
            np.concatenate(ms)
        if xy.shape[0] > cap:
            order = np.argsort(np.where(mask, -inten, np.inf),
                               kind="stable")[:cap]
            xy, inten, mask = xy[order], inten[order], mask[order]
        pad = cap - xy.shape[0]
        if pad > 0:
            xy = np.pad(xy, ((0, pad), (0, 0)))
            inten = np.pad(inten, (0, pad))
            mask = np.pad(mask, (0, pad))
        t = lambda x: torch.as_tensor(x, device=self.device)
        return PointCloud(xy=t(xy.astype(np.float32)),
                          intensity=t(inten.astype(np.float32)), mask=t(mask))

    def _device_store(self):
        """Stacked [N, ...] keyframe cells/peaks/odometry on the device; the
        payload re-uploads only when keyframes were added, the odometry on
        every call (callers may correct poses)."""
        n = len(self.kf_odom)
        if self._store is None or self._store[0] != n:
            up = lambda recs: type(recs[0])(**{
                f.name: torch.as_tensor(np.stack([getattr(r, f.name)
                                                  for r in recs]),
                                        device=self.device)
                for f in dataclasses.fields(recs[0])})
            self._store = (n, up(self.kf_cells), up(self.kf_peaks))
        odom = torch.as_tensor(np.stack(self.kf_odom), device=self.device)
        return self._store[1], self._store[2], odom

    def _db_chunk(self) -> int:
        """The DB growth quantum, a multiple of the mesh size (sharded
        retrieval needs capacity % mesh size == 0)."""
        return -(-self.cfg.scancontext.db_chunk // self._size) * self._size

    def _ensure_capacity(self, n: int) -> None:
        cap = self.db.mask.shape[0]
        if n > cap:
            chunk = self._db_chunk()
            new_cap = ((n + chunk - 1) // chunk) * chunk
            if self._shard is None:
                self.db = grow_db(self.db, new_cap)
            else:
                self.db = par_ret.shard_db(self._shard, grow_db(
                    par_ret.unshard_db(self._shard, self.db), new_cap))

    def _detect(self, descs, rings, q) -> Dict[str, np.ndarray]:
        """``detect`` as host arrays; on a mesh, rank 0's result, which sets
        the pair waves of every rank."""
        det = detect(self.db, descs, rings, q, self.cfg, mesh=self._shard)
        if self._shard is not None:
            det = multihost.broadcast_record(det, self._shard)
        return _fetch(det)

    def _register_verify(self, pairs: bool, *args) -> Dict[str, np.ndarray]:
        """A pair wave (``pairs``) or one query's candidates through the
        single-device form, or split over the mesh's ranks, whose row count
        must divide by the mesh size; host arrays."""
        if self._shard is None:
            fn = register_and_verify_pairs if pairs else register_and_verify
            return _fetch(fn(*args, self.align_model, self.loop_model,
                             self.cfg))
        from ..parallel import candidates as par_cand

        fn = par_cand.sharded_register_and_verify_pairs if pairs \
            else par_cand.sharded_register_and_verify
        return _fetch(fn(self._shard, *args, self.align_model,
                         self.loop_model, self.cfg))

    def process_all_batched(self, detect_chunk: int = 256,
                            pair_chunk: int = 64) -> List[LoopConstraint]:
        """Offline wave mode: all contexts built and inserted, detection over
        query chunks, every (query, candidate) pair registered + verified in
        flat waves of ``pair_chunk``, then per-query acceptance in order
        (ApplyConstratins).  Consumes the unprocessed keyframe range."""
        n = len(self.kf_odom)
        if self._processed >= n:
            return []
        cfg = self.cfg
        dev = self.device
        self._ensure_capacity(n)
        start = self._processed
        total = n - start
        with timing.timer("loop_wave_store"):
            store_cells, store_peaks, store_odom = self._device_store()
        taug_all = augmentation_offsets(cfg, dev)

        chunks = []
        with timing.timer("loop_wave_context"):
            for lo in range(0, total, detect_chunk):
                q = torch.arange(start + lo, start + min(lo + detect_chunk,
                                                         total), device=dev)
                d, r = build_contexts_batched(store_peaks, store_odom, q, n,
                                              cfg)
                db_insert_batch(self.db, q, d[:, 0], r[:, 0], store_odom[q])
                chunks.append((q, d, r))
        dets = []
        with timing.timer("loop_wave_detect"):
            for q, d, r in chunks:
                dets.append(DetectResult(**self._detect(d, r, q)))
        det = DetectResult(**{f.name: np.concatenate(
            [getattr(x, f.name) for x in dets])
            for f in dataclasses.fields(DetectResult)})

        pairs = [(qi, k) for qi in range(total)
                 for k in range(cfg.scancontext.n_candidates)
                 if det.valid[qi, k]]
        results = {}
        pair_chunk = -(-pair_chunk // self._size) * self._size
        with timing.timer("loop_wave_pairs"):
            for lo in range(0, len(pairs), pair_chunk):
                sel = pairs[lo:lo + pair_chunk]
                n_real = len(sel)
                # on a mesh the last wave is padded to a multiple of its
                # size with masked copies of its last pair
                sel = sel + [sel[-1]] * (-n_real % self._size)
                qi_idx = torch.as_tensor([start + qi for qi, _ in sel],
                                         device=dev)
                ci_idx = torch.as_tensor([int(det.index[qi, k])
                                          for qi, k in sel], device=dev)
                g = lambda rec, idx: rec.map(lambda x: x[idx])
                f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32),
                                                device=dev)
                res = self._register_verify(
                    True, g(store_cells, qi_idx), g(store_peaks, qi_idx),
                    g(store_cells, ci_idx), g(store_peaks, ci_idx),
                    taug_all[torch.as_tensor([int(det.aug[qi, k])
                                              for qi, k in sel],
                                             device=dev)],
                    f32([det.yaw[qi, k] for qi, k in sel]),
                    f32([det.dist_sc[qi, k] + det.dist_odom[qi, k]
                         for qi, k in sel]),
                    f32([det.dist_odom[qi, k] for qi, k in sel]),
                    torch.arange(len(sel), device=dev) < n_real)
                for i, key in enumerate(sel[:n_real]):
                    results[key] = {k: v[i] for k, v in res.items()}

        # per-query acceptance in order (ApplyConstratins semantics)
        accepted: List[LoopConstraint] = []
        for qi in range(total):
            cand = [(k, results[(qi, k)])
                    for k in range(cfg.scancontext.n_candidates)
                    if (qi, k) in results]
            for k, r in cand:
                self.candidate_log.append(dict(
                    id_from=start + qi, id_to=int(det.index[qi, k]),
                    prob=float(r["prob"]), sc_sim=float(r["sc_sim"]),
                    odom_bounds=float(r["odom_bounds"]),
                    alignment_quality=float(r["align_quality"]),
                    x6=np.asarray(r["x6"]).tolist(),
                    t_be=np.asarray(r["t_be"]).tolist(), guess_nr=int(k),
                    reg_ok=bool(r["reg_ok"])))
            cand.sort(key=lambda kr: -float(kr[1]["prob"]))
            sel = cand if cfg.verification.all_candidates else cand[:1]
            for k, r in sel:
                if bool(r["valid"]) and \
                        float(r["prob"]) > cfg.verification.model_threshold:
                    c = LoopConstraint(
                        id_from=start + qi, id_to=int(det.index[qi, k]),
                        t_be=np.asarray(r["t_be"]), prob=float(r["prob"]),
                        quality=dict(
                            sc_sim=float(r["sc_sim"]),
                            odom_bounds=float(r["odom_bounds"]),
                            alignment_quality=float(r["align_quality"])),
                        cov=np.asarray(r["cov"]) if bool(r["cov_ok"])
                        else None)
                    self.constraints.append(c)
                    accepted.append(c)
        self._processed = n
        return accepted

    # -- per-keyframe processing (the online schedule) ---------------------
    def process_pending(self) -> List[LoopConstraint]:
        """Process every keyframe whose +-n_aggregate neighbourhood is
        complete."""
        out: List[LoopConstraint] = []
        n_agg = self.cfg.loopclosure.n_aggregate
        while self._processed + n_agg < len(self.kf_odom):
            out.extend(self._process_one(self._processed))
            self._processed += 1
        return out

    def finish(self) -> List[LoopConstraint]:
        """Process the trailing keyframes (incomplete neighbourhoods)."""
        out: List[LoopConstraint] = []
        while self._processed < len(self.kf_odom):
            out.extend(self._process_one(self._processed))
            self._processed += 1
        return out

    def _payload(self, i: int):
        """Keyframe ``i``'s (cells, peaks) on the device, uploaded once."""
        if i not in self._on_device:
            up = lambda x: torch.as_tensor(x, device=self.device)
            self._on_device[i] = (self.kf_cells[i].map(up),
                                  self.kf_peaks[i].map(up))
        return self._on_device[i]

    def _process_one(self, q: int) -> List[LoopConstraint]:
        cfg = self.cfg
        dev = self.device
        self._ensure_capacity(q + 1)
        with timing.timer("loop_descriptor"):
            local_map = self._aggregate_local_map(q).map(lambda x: x[None])
            descs, rings = context_descriptors(local_map, cfg)
            db_insert(self.db, q, descs[0, 0], rings[0, 0],
                      torch.as_tensor(self.kf_odom[q], device=dev))
        with timing.timer("loop_detect"):
            # the one read per keyframe that decides whether to register
            det = {k: v[0] for k, v in self._detect(
                descs, rings, torch.tensor([q], device=dev)).items()}
        if not det["valid"].any():
            return []

        k = cfg.scancontext.n_candidates
        f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev)
        # on a mesh the candidates are padded to a multiple of its size with
        # masked ones
        pad = -k % self._size
        det_p = {name: np.concatenate([v, np.zeros(pad, v.dtype)])
                 for name, v in det.items()}
        with timing.timer("loop_register_verify"):
            cand = [self._payload(int(i))
                    for i in np.where(det_p["valid"], det_p["index"], 0)]
            q_cells, q_peaks = self._payload(q)
            res = self._register_verify(
                False, q_cells, q_peaks, stack_records([c for c, _ in cand]),
                stack_records([p for _, p in cand]),
                augmentation_offsets(cfg, dev)[torch.as_tensor(det_p["aug"],
                                                               device=dev)],
                f32(det_p["yaw"]), f32(det_p["dist_sc"] + det_p["dist_odom"]),
                f32(det_p["dist_odom"]),
                torch.as_tensor(det_p["valid"], device=dev))
            res = {name: v[:k] for name, v in res.items()}

        for i in range(k):
            if det["valid"][i]:
                self.candidate_log.append(dict(
                    id_from=q, id_to=int(det["index"][i]),
                    prob=float(res["prob"][i]),
                    sc_sim=float(res["sc_sim"][i]),
                    odom_bounds=float(res["odom_bounds"][i]),
                    alignment_quality=float(res["align_quality"][i]),
                    x6=res["x6"][i].tolist(), t_be=res["t_be"][i].tolist(),
                    guess_nr=i, reg_ok=bool(res["reg_ok"][i])))

        # ApplyConstratins: best (or all) above threshold
        order = np.argsort(-res["prob"])
        selected = order if cfg.verification.all_candidates else order[:1]
        accepted = []
        for i in selected:
            if res["valid"][i] and \
                    float(res["prob"][i]) > cfg.verification.model_threshold:
                c = LoopConstraint(
                    id_from=q, id_to=int(det["index"][i]),
                    t_be=res["t_be"][i].copy(), prob=float(res["prob"][i]),
                    quality=dict(
                        sc_sim=float(res["sc_sim"][i]),
                        odom_bounds=float(res["odom_bounds"][i]),
                        alignment_quality=float(res["align_quality"][i])),
                    cov=res["cov"][i].copy() if res["cov_ok"][i] else None)
                self.constraints.append(c)
                accepted.append(c)
        return accepted
