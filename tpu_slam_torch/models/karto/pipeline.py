"""Karto-style pose-graph SLAM pipeline — port of
``tpu_slam/models/karto/pipeline.py`` (the online ``KartoSLAM``).

The re-design of `karto::Mapper::Process` and `MapperGraph`
(`lesson6/lib/open_karto/src/Mapper.cpp:1999-2120, 860-1414`) plus the
`SlamKarto` ROS wrapper's scan flow (`lesson6/src/karto_slam.cc:286-505`):

  Process(scan, odom_pose):
    1. propagate last correction onto the new odometric pose (:2023-2024)
    2. HasMovedEnough gate (0.2 m / 10°, :2087-2120)
    3. correlative match vs running scans (ops/correlative.py)  → SetSensorPose
    4. AddVertex → solver AddNode (:883-899)
    5. AddEdges: previous scan, running chain, near chains (:902-973)
       + inverse-covariance weighted pose mean (:1288-1330)
    6. AddRunningScan ring buffer (Mapper.h:1365-1386)
    7. TryCloseLoop: candidate chains → coarse loop match → variance gate →
       fine match gate → LinkChainToScan → CorrectPoses (:976-1051)

All data-dependent control flow (gates, chain building, the BFS
near-linked search, the loop candidate scan) runs on the host over numpy
pose arrays; every match and solve runs on the model's device: a chain
group's match is one pass of ``CorrelativeMatcher`` over the device scan
store, read back once, and a solve is ``PoseGraphSolver.compute``. The
padded shape ladder of the reference (``_bucket``, 1 or 8 lanes) is kept
although PyTorch compiles nothing: padding changes which points exist, and
the results must equal the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque

import numpy as np
import torch

from tpu_slam_torch._dispatch import DEFAULT_DEVICE
from tpu_slam_torch.config import SLAMConfig
from tpu_slam_torch.data.scan import Scan, index_scan
from tpu_slam_torch.ops.correlative import (
    CorrelativeMatcher,
    CorrelativeParams,
    MatchResult,
    to_host,
)
from tpu_slam_torch.parallel.loop_search import make_ring_loop_search
from tpu_slam_torch.solver.pose_graph import PoseGraphSolver
from tpu_slam_torch.utils.events import EventBus
from tpu_slam_torch.utils.profiling import StageTimer


@dataclasses.dataclass(frozen=True)
class LaserRig:
    """Laser device registration (SlamKarto::getLaser, karto_slam.cc:327-405
    + LaserRangeFinder::SetOffsetPose, Karto.h:3709).

    ``offset`` is the laser's SE(2) pose relative to the robot base; the
    mapper tracks BASE poses at its API boundary and sensor poses internally
    (GetSensorAt = base ∘ offset). ``inverted`` reproduces the upside-down
    mount handling: readings are reversed before processing
    (karto_slam.cc:417-425)."""

    offset: tuple = (0.0, 0.0, 0.0)  # (x, y, yaw) laser wrt base
    inverted: bool = False

    @staticmethod
    def from_mount(
        x: float, y: float, z: float,
        roll: float, pitch: float, yaw: float,
    ) -> "LaserRig":
        """Detect an upside-down mount from the full 3D laser pose, exactly
        as the reference: a point 1 m above the base, transformed into the
        laser frame, has z ≤ 0 iff the laser is inverted
        (karto_slam.cc:359-380)."""
        cr, sr = math.cos(roll), math.sin(roll)
        cp, sp = math.cos(pitch), math.sin(pitch)
        cy, sy = math.cos(yaw), math.sin(yaw)
        # up point in laser frame: R(yaw,pitch,roll)ᵀ · (-x, -y, 1); its z
        # uses the third COLUMN of R (ZYX convention)
        up_z = (
            (cy * sp * cr + sy * sr) * (-x)
            + (sy * sp * cr - cy * sr) * (-y)
            + cp * cr
        )
        return LaserRig(offset=(x, y, yaw), inverted=up_z <= 0.0)

    @property
    def is_identity(self) -> bool:
        return not self.inverted and all(v == 0.0 for v in self.offset)


@dataclasses.dataclass
class SensorState:
    """Per-sensor scan manager (karto::ScanManager inside
    MapperSensorManager, Mapper.h:1288-1404): each registered laser keeps
    its own scan list, running buffer and last-scan pointer; the pose graph
    and solver are shared across sensors."""

    name: str
    laser: LaserRig
    offset: np.ndarray  # (3,) f64 laser-in-base offset
    scan_ids: list = dataclasses.field(default_factory=list)  # global ids
    running: "deque[int]" = dataclasses.field(default_factory=deque)
    last_scan_id: int | None = None


class DeviceScanStore:
    """Device-resident store of immutable laser-frame scan points.

    Scan POINTS never change after acceptance (only poses do), so they
    upload to the device exactly once, one host→device copy per accepted
    scan; matchers address them by row index
    (CorrelativeMatcher.match_chains_store), so a match uploads indices
    and poses, not point data. Capacity grows in ×4 steps, as the
    reference's does (its rows past ``count`` are zero, and a padded
    chain member reads row 0 masked, as there)."""

    def __init__(self, n_beams: int, init_cap: int = 512,
                 device=DEFAULT_DEVICE):
        self.n_beams = n_beams
        self.count = 0
        self.pts = torch.zeros((init_cap, n_beams, 2), dtype=torch.float32,
                               device=device)
        self.valid = torch.zeros((init_cap, n_beams), dtype=torch.bool,
                                 device=device)

    def append(self, pts: np.ndarray, valid: np.ndarray) -> int:
        cap = self.pts.shape[0]
        if self.count == cap:
            grow = 3 * cap
            self.pts = torch.cat([self.pts, self.pts.new_zeros(
                (grow, self.n_beams, 2))])
            self.valid = torch.cat([self.valid, self.valid.new_zeros(
                (grow, self.n_beams))])
        i = self.count
        row = np.concatenate([np.asarray(pts, np.float32),
                              np.asarray(valid, np.float32)[:, None]], 1)
        row = torch.as_tensor(row).to(self.pts.device)  # the one upload
        self.pts[i] = row[:, :2]
        self.valid[i] = row[:, 2] > 0.5
        self.count += 1
        return i


@dataclasses.dataclass
class ScanRecord:
    """LocalizedRangeScan analogue (Karto.h:5171-5470): laser-frame points
    are immutable; world data derives from the (mutable) corrected pose."""

    state_id: int
    pts_laser: np.ndarray  # (N, 2) endpoints of ALL beams (0 where not finite)
    beam_valid: np.ndarray  # (N,) finite — the matcher mask: the reference
    # matches on UNFILTERED point readings (GetPointReadings default,
    # Karto.h:5336; lookup INVALID_SCAN only for NaN/inf, Karto.h:6477-6482)
    bary_local: np.ndarray  # (2,) mean of FILTERED laser points
    odom_pose: np.ndarray  # (3,)
    corrected_pose: np.ndarray  # (3,) sensor pose (updated by matching/solver)
    ranges: np.ndarray = None  # (N,) raw readings (occupancy filtering/clamp)
    time: float = 0.0  # scan timestamp, seconds (GetTime)
    sensor: str = "laser0"  # GetSensorName (Karto.h:5208)
    seq: int = 0  # per-sensor StateId (per-sensor scan-list index)
    store_row: int = -1  # row in the DeviceScanStore for this beam count

    def reference_position(self, use_barycenter: bool) -> np.ndarray:
        """GetReferencePose (Karto.h:5280-5299)."""
        if not use_barycenter:
            return self.corrected_pose[:2]
        c, s = math.cos(self.corrected_pose[2]), math.sin(self.corrected_pose[2])
        bx, by = self.bary_local
        return self.corrected_pose[:2] + np.array(
            [c * bx - s * by, s * bx + c * by]
        )


def _np_compose(a, b):
    """Host-side f64 pose composition (keeps bookkeeping at full precision)."""
    c, s = math.cos(a[2]), math.sin(a[2])
    th = a[2] + b[2]
    return np.array(
        [
            a[0] + c * b[0] - s * b[1],
            a[1] + s * b[0] + c * b[1],
            math.atan2(math.sin(th), math.cos(th)),
        ]
    )


def _np_rel(a, b):
    c, s = math.cos(a[2]), math.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    th = b[2] - a[2]
    return np.array(
        [
            c * dx + s * dy,
            -s * dx + c * dy,
            math.atan2(math.sin(th), math.cos(th)),
        ]
    )


def _np_inv(a):
    c, s = math.cos(a[2]), math.sin(a[2])
    return np.array(
        [-(c * a[0] + s * a[1]), -(-s * a[0] + c * a[1]), -a[2]]
    )


class KartoSLAM:
    def __init__(self, cfg: SLAMConfig, laser: LaserRig | None = None,
                 device=DEFAULT_DEVICE, mesh=None):
        """Matching and solving run on ``device``. With a ``mesh``
        (``parallel/mesh.Mesh``) they run on the mesh's device, the back
        end's LM with its edges sharded over the ranks
        (``PoseGraphSolver(mesh=mesh)``) and the loop-candidate sweep
        through the keyframe ring-pass (``parallel/loop_search``). Every
        rank runs the whole front end on the same scans, as every process
        does in the reference."""
        self.cfg = cfg
        self.mesh = mesh
        self._ring_search = None  # built at the first sweep (mesh only)
        self.device = torch.device(device if mesh is None else mesh.device)
        # laser device registration: offset pose + upside-down handling
        # (SlamKarto::getLaser). API-boundary poses are BASE poses when a
        # rig with an offset is registered; internal poses stay sensor poses.
        # Multiple lasers: one SensorState per registered device feeding the
        # shared graph (MapperSensorManager, Mapper.h:1288-1404).
        self.sensors: dict[str, SensorState] = {}
        self.default_sensor = "laser0"
        self.register_laser("laser0", laser or LaserRig())
        c = cfg.correlative
        rng_th = cfg.scan.range_threshold
        self.front_matcher = CorrelativeMatcher(
            CorrelativeParams(
                search_size=c.correlation_search_space_dimension,
                resolution=c.correlation_search_space_resolution,
                smear_deviation=c.correlation_search_space_smear_deviation,
                range_threshold=rng_th,
                angle_offset=c.coarse_search_angle_offset,
                angle_res=c.coarse_angle_resolution,
                fine_angle_offset=c.fine_search_angle_offset,
                distance_variance_penalty=c.distance_variance_penalty,
                angle_variance_penalty=c.angle_variance_penalty,
                minimum_distance_penalty=c.minimum_distance_penalty,
                minimum_angle_penalty=c.minimum_angle_penalty,
            ),
            use_response_expansion=c.use_response_expansion,
            device=self.device,
        )
        lp = cfg.loop
        self.loop_matcher = CorrelativeMatcher(
            CorrelativeParams(
                search_size=lp.loop_search_space_dimension,
                resolution=lp.loop_search_space_resolution,
                smear_deviation=lp.loop_search_space_smear_deviation,
                range_threshold=rng_th,
                angle_offset=c.coarse_search_angle_offset,
                angle_res=c.coarse_angle_resolution,
                fine_angle_offset=c.fine_search_angle_offset,
            ),
            use_response_expansion=c.use_response_expansion,
            device=self.device,
        )
        self.solver = PoseGraphSolver(cfg.solver, device=self.device,
                                      mesh=mesh)
        self._pending = None  # in-flight async back-end solve
        self._flushed_edges = -1  # edge count at the last flush-time solve
        self.scans: list[ScanRecord] = []
        self.adjacency: dict[int, set[int]] = {}
        # (i, j, kind) per solver constraint — kind ∈ {"sequential",
        # "chain", "loop"} — feeding the pose-graph visualization
        # (utils.map_io.save_graph_png; the MarkerArray debugging role of
        # karto_slam.cc:603-682)
        self.graph_edges: list[tuple[int, int, str]] = []
        self._last_processed: int | None = None  # across all sensors
        # one device-resident point store per beam count (mixed-N chain
        # groups fall back to the data-carrying path)
        self._stores: dict[int, DeviceScanStore] = {}
        self.loop_closures = 0
        self._base_buckets = {}
        # in-flight speculative front match for the NEXT scan (dispatched
        # during the current scan's loop search; see
        # cfg.karto.speculative_front_match)
        self._spec: dict | None = None
        # MapperListener analogue (Mapper.h:35-83): loop-closure decisions
        # and progress surface through this bus
        self.events = EventBus()
        # per-stage wall clocks (the reference's chrono prints, SURVEY §5)
        self.timer = StageTimer()

    # --- sensor registry (MapperSensorManager::RegisterSensor) --------------
    def register_laser(self, name: str, laser: LaserRig | None = None):
        """Register a laser device (SlamKarto::getLaser registers one rig
        per frame_id, karto_slam.cc:327-405)."""
        rig = laser or LaserRig()
        self.sensors[name] = SensorState(
            name=name,
            laser=rig,
            offset=np.asarray(rig.offset, np.float64),
        )

    # single-sensor convenience views (the common case and the pre-multi-
    # sensor API): the default sensor's rig / running buffer / last scan
    @property
    def laser(self) -> LaserRig:
        return self.sensors[self.default_sensor].laser

    @property
    def running(self) -> "deque[int]":
        return self.sensors[self.default_sensor].running

    @property
    def _last_scan_id(self) -> int | None:
        return self.sensors[self.default_sensor].last_scan_id

    # --- scan bookkeeping ---------------------------------------------------
    def _make_record(
        self, scan: Scan, odom_pose: np.ndarray, sensor: str
    ) -> ScanRecord:
        # polar->Cartesian on the HOST: the record is host state, and doing
        # this as a device op would cost fetch round-trips per scan (including
        # the ones HasMovedEnough rejects)
        st = self.sensors[sensor]
        r = to_host(scan.ranges)
        # beam angles recomputed in f64 from the sensor model — the
        # reference works in doubles throughout (Karto.h:5383); the Scan's
        # f32 angle table would shift endpoints by ~1e-7 rad, enough to flip
        # cell rounding at exact half-cell boundaries
        a = self.cfg.scan.angle_min + self.cfg.scan.angle_increment * (
            np.arange(r.shape[0], dtype=np.float64)
        )
        if st.laser.inverted:
            # upside-down mount: readings reversed (karto_slam.cc:417-425)
            r = r[::-1]
        # the reference fork's LaserRangeFinder::Update computes the reading
        # count WITHOUT the +1 (Karto.h:4152-4161, original commented out):
        # Round((angle_max − angle_min)/resolution) — one fewer than the
        # message carries under the usual angle_max = min + (n−1)·res
        # convention, so the LAST beam never enters processing
        n = r.shape[0]
        sc = self.cfg.scan
        span = sc.angle_increment * (n - 1)
        n_used = int(math.floor(span / sc.angle_increment + 0.5))
        if n_used < n:
            r = r[:n_used]
            a = a[:n_used]
        # endpoints for ALL beams, RAW: the reference matcher works on
        # UNFILTERED point readings (LocalizedRangeScan::Update computes a
        # world point per beam regardless of range, Karto.h:5378-5404) —
        # inf-range beams keep their ±inf endpoints because FindValidPoints'
        # walk treats them as anchors (see ops.correlative.find_valid_points);
        # NaN/inf beams are masked in the response lookup (INVALID_SCAN)
        finite = np.isfinite(r)
        with np.errstate(invalid="ignore"):
            pts = np.stack([r * np.cos(a), r * np.sin(a)], axis=-1)
        # barycenter over the FILTERED readings (InRange(r, min, threshold),
        # Karto.h:5381,5405-5417)
        filt = finite & (r >= self.cfg.scan.range_min) & (
            r <= self.cfg.scan.range_threshold
        )
        bary = pts[filt].mean(axis=0) if filt.any() else np.zeros(2)
        # odom_pose arrives as a BASE pose; internal poses are sensor poses
        # (GetSensorAt = base ∘ offset, Karto.h:5331-5345)
        sensor_odom = np.asarray(odom_pose, np.float64)
        if not st.laser.is_identity:
            sensor_odom = _np_compose(sensor_odom, st.offset)
        return ScanRecord(
            state_id=len(self.scans),
            pts_laser=pts.astype(np.float32),
            beam_valid=finite,
            bary_local=bary,
            ranges=r.astype(np.float32),
            odom_pose=sensor_odom,
            corrected_pose=sensor_odom.copy(),
            time=float(to_host(scan.stamp)),
            sensor=sensor,
            seq=len(st.scan_ids),
        )

    def _has_moved_enough(self, rec: ScanRecord) -> bool:
        """HasMovedEnough (Mapper.cpp:2087-2120): odometric travel gates,
        vs the last scan of the SAME sensor (GetLastScan(rSensorName))."""
        last_id = self.sensors[rec.sensor].last_scan_id
        if last_id is None:
            return True
        return self._moved_between(self.scans[last_id], rec)

    def _moved_between(self, last: ScanRecord, rec: ScanRecord) -> bool:
        k = self.cfg.karto
        # enough time passed (MinimumTimeInterval gate, Mapper.cpp:2095-2099)
        if rec.time - last.time >= k.minimum_time_interval:
            return True
        d = rec.odom_pose[:2] - last.odom_pose[:2]
        dth = abs(
            math.atan2(
                math.sin(rec.odom_pose[2] - last.odom_pose[2]),
                math.cos(rec.odom_pose[2] - last.odom_pose[2]),
            )
        )
        return (
            dth >= k.minimum_travel_heading
            or d @ d >= k.minimum_travel_distance**2
        )

    # --- matching helpers ---------------------------------------------------
    def _bucket(self, n: int) -> int:
        """Padded scan-count ladder of the reference (its XLA executables
        are one per shape). Padded scans add no point to the grid."""
        for b in (16, 128, 512):
            if n <= b:
                return b
        b = 512
        while b < n:
            b *= 4
        return b

    def _chain_batch_inputs(self, chains: list[list[int]]):
        """AddScans inputs for a group of chains (Mapper.cpp:699-763): each
        lane carries one chain's scan poses + laser points, padded to the
        reference's (lanes, scans) footprint. The world transform and view
        filter run on the device (CorrelativeMatcher._full_chains)."""
        cap_c = 1 if len(chains) == 1 else 8  # the reference's two shapes
        cap_s = self._bucket(max(len(c) for c in chains))
        # lasers may have different beam counts (one shape per registered
        # sensor); pad every record to the largest, invalid-padded
        n = max(
            self.scans[i].pts_laser.shape[0] for c in chains for i in c
        )
        poses = np.zeros((cap_c, cap_s, 3), np.float32)
        # NaN padding: FindValidPoints walks UNMASKED points (reference
        # semantics) and a (0,0) pad point could become an anchor; NaN never
        # does (ops.correlative.find_valid_points)
        pts = np.full((cap_c, cap_s, n, 2), np.nan, np.float32)
        valid = np.zeros((cap_c, cap_s, n), bool)
        lane_valid = np.zeros(cap_c, bool)
        for k, chain in enumerate(chains):
            lane_valid[k] = True
            for j, i in enumerate(chain):
                r = self.scans[i]
                nb = r.pts_laser.shape[0]
                poses[k, j] = r.corrected_pose
                pts[k, j, :nb] = r.pts_laser
                valid[k, j, :nb] = r.beam_valid
        return poses, pts, valid, lane_valid

    def _match_chains(
        self, matcher: CorrelativeMatcher, rec: ScanRecord,
        chains: list[list[int]], center_pose: np.ndarray,
        do_penalize=True, do_fine=True, group=8,
    ) -> list[MatchResult]:
        """Match ``rec`` against every chain: one device pass per group of
        ≤``group`` (default 8) chains, every group queued before the first
        is read back (the reference's C++ runs one sequential MatchScan per
        chain, Mapper.cpp:902-973 / :976-1051). Lanes are padded to 1 or 8
        as in the reference. Chain points come from the device store by
        row index whenever the group's scans share one beam count."""
        out = []
        ns = {self.scans[i].pts_laser.shape[0] for c in chains for i in c}
        store = self._stores.get(next(iter(ns))) if len(ns) == 1 else None
        if store is not None and any(
            self.scans[i].store_row < 0 for c in chains for i in c
        ):
            store = None  # restored-from-checkpoint records, not uploaded
        # queue every group's match, then read them back
        pend = []
        for g0 in range(0, len(chains), group):
            grp = chains[g0 : g0 + group]
            if store is not None:
                poses, idx, lane_valid = self._chain_batch_indices(grp)
                pend.append((
                    grp,
                    matcher.match_chains_store_async(
                        store.pts, store.valid, idx, poses,
                        rec.pts_laser, rec.beam_valid,
                        np.asarray(center_pose, np.float32),
                        do_penalize=do_penalize, do_fine=do_fine,
                        lane_valid=lane_valid,
                    ),
                ))
            else:
                poses, pts, valid, lane_valid = self._chain_batch_inputs(grp)
                r = matcher.match_chains(
                    poses, pts, valid, rec.pts_laser, rec.beam_valid,
                    np.asarray(center_pose, np.float32),
                    do_penalize=do_penalize, do_fine=do_fine,
                    lane_valid=lane_valid,
                )
                pend.append((grp, r))
        for grp, r in pend:
            if hasattr(r, "resolve"):
                r = r.resolve()
            for k in range(len(grp)):
                out.append(
                    MatchResult(r.pose[k], r.response[k], r.covariance[k])
                )
        return out

    def _chain_batch_indices(self, chains: list[list[int]]):
        """Store-row form of _chain_batch_inputs: (C, S) row indices
        (−1 = padded) + (C, S, 3) poses."""
        cap_c = 1 if len(chains) == 1 else 8  # the reference's two shapes
        cap_s = self._bucket(max(len(c) for c in chains))
        poses = np.zeros((cap_c, cap_s, 3), np.float32)
        idx = np.full((cap_c, cap_s), -1, np.int32)
        lane_valid = np.zeros(cap_c, bool)
        for k, chain in enumerate(chains):
            lane_valid[k] = True
            for j, i in enumerate(chain):
                r = self.scans[i]
                poses[k, j] = r.corrected_pose
                idx[k, j] = r.store_row
        return poses, idx, lane_valid

    def _match(
        self, matcher: CorrelativeMatcher, rec: ScanRecord, ids: list[int],
        center_pose: np.ndarray, do_penalize=True, do_fine=True,
    ) -> MatchResult:
        return self._match_chains(
            matcher, rec, [list(ids)], center_pose,
            do_penalize=do_penalize, do_fine=do_fine,
        )[0]

    # --- graph helpers ------------------------------------------------------
    def _link(self, i: int, j: int, mean_pose_j: np.ndarray, cov: np.ndarray,
              kind: str = "chain"):
        """LinkScans (Mapper.cpp:1104-1122): edge i→j with measurement =
        pose_j expressed in scan i's sensor frame (LinkInfo pose difference),
        skipped if the edge already exists. ``kind`` tags the edge for the
        graph visualization (sequential / chain / loop)."""
        if j in self.adjacency.get(i, set()):
            return
        self.adjacency.setdefault(i, set()).add(j)
        self.adjacency.setdefault(j, set()).add(i)
        self.graph_edges.append((i, j, kind))
        mean = _np_rel(self.scans[i].corrected_pose, mean_pose_j)
        self.solver.add_constraint(i, j, mean, covariance=np.asarray(cov, np.float64))

    def _link_chain(self, chain: list[int], j: int, mean_pose_j, cov,
                    kind: str = "chain"):
        """LinkChainToScan (Mapper.cpp:1152-1167): link the chain scan
        closest to scan j's reference pose."""
        k = self.cfg.karto
        ref = self.scans[j].reference_position(k.use_scan_barycenter)
        best, best_d = None, np.inf
        for i in chain:
            d = np.sum(
                (self.scans[i].reference_position(k.use_scan_barycenter) - ref)
                ** 2
            )
            if d < best_d:
                best, best_d = i, d
        if best is not None and best_d < k.link_scan_maximum_distance**2 + 1e-6:
            self._link(best, j, mean_pose_j, cov, kind=kind)

    def _all_ref_positions(self) -> np.ndarray:
        """Reference positions of every scan, vectorized (GetReferencePose,
        Karto.h:5280-5299). Valid until the next pose mutation; callers
        recompute per gather round, so loop-candidate scans and BFS gates
        are O(n) numpy instead of per-scan python math."""
        if not self.scans:
            return np.zeros((0, 2))
        poses = np.stack([r.corrected_pose for r in self.scans])
        if not self.cfg.karto.use_scan_barycenter:
            return poses[:, :2]
        bary = np.stack([r.bary_local for r in self.scans])
        c, s = np.cos(poses[:, 2]), np.sin(poses[:, 2])
        return poses[:, :2] + np.stack(
            [c * bary[:, 0] - s * bary[:, 1],
             s * bary[:, 0] + c * bary[:, 1]], axis=-1
        )

    def _near_linked_scans(
        self, sid: int, max_dist: float, refs: np.ndarray | None = None
    ) -> list[int]:
        """FindNearLinkedScans (Mapper.cpp:1278-1286): BFS over graph edges,
        expanding only through vertices within max_dist of the scan's
        reference pose (NearScanVisitor, Mapper.h:619-648)."""
        if refs is None:
            refs = self._all_ref_positions()
        near = (
            np.sum((refs - refs[sid]) ** 2, axis=-1) < max_dist**2 + 1e-6
        )
        seen = {sid}
        out = []
        q = deque([sid])
        while q:
            v = q.popleft()
            if near[v]:
                out.append(v)
                for w in self.adjacency.get(v, ()):  # expand accepted only
                    if w not in seen:
                        seen.add(w)
                        q.append(w)
        return out

    def _find_near_chains(self, sid: int) -> list[list[int]]:
        """FindNearChains (Mapper.cpp:1170-1275)."""
        k = self.cfg.karto
        refs = self._all_ref_positions()
        in_range = (
            np.sum((refs - refs[sid]) ** 2, axis=-1)
            < k.link_scan_maximum_distance**2 + 1e-6
        )
        processed = set()
        chains = []
        for near in self._near_linked_scans(
            sid, k.link_scan_maximum_distance, refs
        ):
            if near == sid or near in processed:
                continue
            processed.add(near)
            # chains extend along the NEAR scan's sensor scan list
            # (GetScan(pNearScan->GetSensorName(), candidateScanNum),
            # Mapper.cpp:1208-1211)
            slist = self.sensors[self.scans[near].sensor].scan_ids
            seq = self.scans[near].seq
            valid_chain = True
            chain = []
            for cs in range(seq - 1, -1, -1):  # scans before
                cand = slist[cs]
                if cand == sid:
                    valid_chain = False
                if in_range[cand]:
                    chain.insert(0, cand)
                    processed.add(cand)
                else:
                    break
            chain.append(near)
            for cs in range(seq + 1, len(slist)):  # scans after
                cand = slist[cs]
                if cand == sid:
                    valid_chain = False
                if in_range[cand]:
                    chain.append(cand)
                    processed.add(cand)
                else:
                    break
            if valid_chain:
                chains.append(chain)
        return chains

    def _add_edges(self, rec: ScanRecord, cov: np.ndarray):
        """AddEdges (Mapper.cpp:902-973). The previous-scan and running-
        chain links are within rec's sensor (GetScan(rSensorName, id−1) /
        GetRunningScans(rSensorName)); near chains may cross sensors."""
        sid = rec.state_id
        st = self.sensors[rec.sensor]
        means, covs = [], []
        if st.last_scan_id is not None:
            # 1) previous scan of the same sensor
            self._link(st.last_scan_id, sid, rec.corrected_pose, cov,
                       kind="sequential")
            # 2) running chain (one edge to the closest running scan)
            means.append(rec.corrected_pose.copy())
            covs.append(np.asarray(cov, np.float64))
            self._link_chain(list(st.running), sid, rec.corrected_pose, cov)
        else:
            # first scan of this sensor: match against every OTHER sensor's
            # scans and link to that sensor's scan 0 ("link to first scan of
            # other robots", Mapper.cpp:922-953). Edge added regardless of
            # response; only strong responses join the weighted mean.
            for name, ost in self.sensors.items():
                if name == rec.sensor or not ost.scan_ids:
                    continue
                res = self._match(
                    self.front_matcher, rec, list(ost.scan_ids),
                    rec.corrected_pose,
                )
                mean = np.asarray(res.pose, np.float64)
                c = np.asarray(res.covariance, np.float64)
                self._link(ost.scan_ids[0], sid, mean, c,
                           kind="sequential")
                if (
                    float(res.response)
                    > self.cfg.karto.link_match_minimum_response_fine
                ):
                    means.append(mean)
                    covs.append(c)
        # 3) near chains — all matched in one batched device program
        # (the reference's per-chain MatchScan loop, Mapper.cpp:928-967)
        k = self.cfg.karto
        with self.timer.stage("near_gather"):
            chains = [
                c
                for c in self._find_near_chains(sid)
                if len(c) >= self.cfg.loop.loop_match_minimum_chain_size
            ]
        if chains:
            # dense revisit areas surface many near chains at once; the
            # small front-end grids afford 8 lanes per program, halving
            # the dispatch+sync count exactly where missions grow
            with self.timer.stage("near_match"):
                results = self._match_chains(
                    self.front_matcher, rec, chains, rec.corrected_pose,
                    do_penalize=False, group=8,
                )
            for chain, res in zip(chains, results):
                if (
                    float(res.response)
                    > k.link_match_minimum_response_fine - 1e-6
                ):
                    mean = np.asarray(res.pose, np.float64)
                    c = np.asarray(res.covariance, np.float64)
                    means.append(mean)
                    covs.append(c)
                    self._link_chain(chain, sid, mean, c)
        if means:
            rec.corrected_pose = self._weighted_mean(means, covs)

    @staticmethod
    def _weighted_mean(means, covs) -> np.ndarray:
        """ComputeWeightedMean (Mapper.cpp:1288-1330).

        Corridor-degenerate matches can produce an EXACTLY singular
        covariance (the response keep-set collinear → rank-1 positional
        block); the reference then dies on Matrix3::Inverse's assert (or
        silently uses garbage under NDEBUG, Karto.h:2444-2453). Deviation:
        regularize with a tiny diagonal jitter instead — same result on
        non-degenerate input, well-defined on degenerate input (PARITY.md)."""

        def safe_inv(c):
            try:
                return np.linalg.inv(c)
            except np.linalg.LinAlgError:
                return np.linalg.inv(c + 1e-9 * np.eye(3))

        invs = [safe_inv(c) for c in covs]
        w_total = safe_inv(np.sum(invs, axis=0))
        acc = np.zeros(3)
        tx = ty = 0.0
        for m, inv in zip(means, invs):
            acc += w_total @ inv @ m
            tx += math.cos(m[2])
            ty += math.sin(m[2])
        acc[2] = math.atan2(ty / len(means), tx / len(means))
        return acc

    def _add_running(self, rec: ScanRecord):
        """AddRunningScan (Mapper.h:1365-1386), per sensor."""
        running = self.sensors[rec.sensor].running
        running.append(rec.state_id)
        k = self.cfg.karto
        while len(running) > 1:
            front = self.scans[running[0]]
            back = self.scans[running[-1]]
            d2 = np.sum(
                (back.corrected_pose[:2] - front.corrected_pose[:2]) ** 2
            )
            if (
                len(running) > k.scan_buffer_size
                or d2 > k.scan_buffer_maximum_scan_distance**2 - 1e-6
            ):
                running.popleft()
            else:
                break

    def _find_possible_loop(self, sid: int, start: int, sensor: str,
                            gather_state=None):
        """FindPossibleLoopClosure (Mapper.cpp:1333-1394): candidate chains
        come from ``sensor``'s scan list (GetScans(rSensorName) — the caller
        iterates all registered sensors, Mapper.cpp:2064-2069); ``start`` is
        a seq index into that list. Returns (chain of global ids,
        next_start).

        gather_state: optional precomputed (near_linked set, in_range mask)
        — constant within one candidate-gather pass (poses only change when
        a closure succeeds, and the caller re-gathers then), so hoisting it
        turns O(candidates) BFS+refs recomputation into one per pass."""
        lp = self.cfg.loop
        if gather_state is None:
            gather_state = self._loop_gather_state(sid)
        near_linked, in_range = gather_state
        slist = self.sensors[sensor].scan_ids
        chain = []
        n = len(slist)
        s = start
        while s < n:
            i = slist[s]
            if in_range[i]:
                if i in near_linked:
                    chain = []
                else:
                    chain.append(i)
            else:
                if len(chain) >= lp.loop_match_minimum_chain_size:
                    return chain, s
                chain = []
            s += 1
        return (
            chain if len(chain) >= lp.loop_match_minimum_chain_size else [],
            n,
        )

    def _loop_gather_state(self, sid: int):
        """(near_linked, in_range) for one loop-candidate gather pass."""
        lp = self.cfg.loop
        refs = self._all_ref_positions()
        near_linked = set(
            self._near_linked_scans(
                sid, lp.loop_search_maximum_distance, refs
            )
        )
        if self.mesh is not None:
            d2 = self._ring_distances(refs[sid], refs)
            # the ring pass computes d2 in float32 where the single-device
            # sweep is float64: keyframes within its rounding of the range
            # boundary are recomputed exactly here, so that both accept
            # the same candidates
            t2 = lp.loop_search_maximum_distance**2
            border = np.abs(d2 - t2) < 1e-3
            if border.any():
                d2[border] = np.sum((refs[border] - refs[sid]) ** 2, axis=-1)
        else:
            d2 = np.sum((refs - refs[sid]) ** 2, axis=-1)
        in_range = d2 < lp.loop_search_maximum_distance**2 + 1e-6
        return near_linked, in_range

    def _ring_distances(self, query: np.ndarray, refs: np.ndarray):
        """Query↔keyframe squared distances through the mesh ring-pass
        (``parallel/loop_search.make_ring_loop_search``): the keyframes
        padded with far rows (1e9) to a power-of-two block a rank, every
        rank asking the same query; returns the rank's own query row,
        float64."""
        if self._ring_search is None:
            self._ring_search = make_ring_loop_search(self.mesh)
        D = self.mesh.size
        n = refs.shape[0]
        blk = 1
        while blk * D < max(n, 16):
            blk *= 2
        kf = np.full((blk * D, 2), 1e9, np.float32)
        kf[:n] = refs
        q = np.broadcast_to(np.asarray(query, np.float32), (D, 2)).copy()
        f32 = dict(dtype=torch.float32, device=self.device)
        d2 = self._ring_search(torch.as_tensor(q, **f32),
                               torch.as_tensor(kf, **f32))
        return d2[self.mesh.rank, :n].double().cpu().numpy()

    def _correct_poses(self):
        """CorrectPoses (Mapper.cpp:1397-1414): solve + write back.

        In async mode (cfg.karto.async_loop_closure) the solve is only
        DISPATCHED here; `_poll_correction` applies it when the device
        finishes, while scan processing continues — the pipeline-parallel
        split the reference lacks (its solve blocks the scan callback)."""
        if self.cfg.karto.async_loop_closure:
            self._poll_correction(force=True)  # one solve in flight at most
            self._pending = self.solver.compute_async()
            return
        with self.timer.stage("solve"):
            self.solver.compute()
        out = self.solver.get_poses()
        for rec, p in zip(self.scans, out):
            rec.corrected_pose = np.asarray(p, np.float64)

    def _poll_correction(self, force: bool = False):
        """Harvest a finished async solve: write the snapshot's corrected
        poses, then propagate the correction chain-consistently to scans
        accepted while the back-end was running (their relative odometry
        hangs off the snapshot's last node)."""
        if self._pending is None:
            return
        if not (force or self._pending.ready()):
            return
        pend, self._pending = self._pending, None
        n = pend.n_nodes
        old_last = self.scans[n - 1].corrected_pose.copy()
        pend.harvest()
        out = self.solver.get_poses()
        for rec, p in zip(self.scans[:n], out[:n]):
            rec.corrected_pose = np.asarray(p, np.float64)
        if len(self.scans) > n:
            T = _np_compose(
                self.scans[n - 1].corrected_pose, _np_inv(old_last)
            )
            for rec in self.scans[n:]:
                rec.corrected_pose = _np_compose(T, rec.corrected_pose)
                self.solver.set_node_pose(rec.state_id, rec.corrected_pose)
            self.events.debug(
                f"async correction harvested: {n} solved nodes, "
                f"{len(self.scans) - n} propagated"
            )

    def flush(self):
        """Block until any in-flight back-end solve is applied, then bring
        the mission to the reference's fully-solved end state.

        Async mode trades correction latency for pipeline overlap DURING
        the mission: scans and edges accepted between a solve dispatch and
        its harvest only ever receive the chain-consistent propagation, and
        closures found after the last dispatch are never solved at all. The
        reference's blocking CorrectPoses (Mapper.cpp:1397-1414) leaves no
        such tail — measured on the 1-lap outdoor online mission, skipping
        this final solve costs ATE 0.142 vs 0.024 m. One synchronous solve
        over the complete graph (skipped when nothing changed since the
        last one) restores parity."""
        self._poll_correction(force=True)
        if (
            self.cfg.karto.async_loop_closure
            and self.loop_closures
            and self.solver.num_edges != self._flushed_edges
        ):
            with self.timer.stage("solve"):
                self.solver.compute()
            out = self.solver.get_poses()
            for rec, p in zip(self.scans, out):
                rec.corrected_pose = np.asarray(p, np.float64)
            self._flushed_edges = self.solver.num_edges

    def _try_close_loop(self, rec: ScanRecord) -> bool:
        """TryCloseLoop (Mapper.cpp:976-1051).

        The reference's while loop runs one coarse loop-match per candidate
        chain sequentially. Failed attempts don't mutate state, so all
        candidate chains (found host-side from the CURRENT poses) are coarse-
        matched in one batched device program; only when a closure succeeds
        (poses change) are the remaining candidates re-gathered from the new
        poses — reproducing the sequential semantics exactly."""
        sid = rec.state_id
        closed = False
        # the reference tries loop closure against EVERY registered
        # sensor's scan list (Mapper.cpp:2064-2069)
        for sname in self.sensors:
            start = 0
            while True:
                # gather every candidate chain from the current poses
                # (host only)
                cands = []
                s = start
                with self.timer.stage("loop_gather"):
                    gs = self._loop_gather_state(sid)
                    while True:
                        chain, s = self._find_possible_loop(
                            sid, s, sname, gather_state=gs
                        )
                        if not chain:
                            break
                        cands.append((chain, s))
                if not cands:
                    break
                with self.timer.stage("loop_coarse"):
                    coarse_all = self._match_chains(
                        self.loop_matcher, rec, [c for c, _ in cands],
                        rec.corrected_pose, do_penalize=False, do_fine=False,
                    )
                progressed = False
                for (chain, nxt), coarse in zip(cands, coarse_all):
                    start = nxt
                    if self._attempt_loop_closure(rec, chain, coarse):
                        closed = True
                        progressed = True
                        break  # poses changed → re-gather candidates
                if not progressed:
                    break
        return closed

    def _attempt_loop_closure(
        self, rec: ScanRecord, chain: list[int], coarse: MatchResult
    ) -> bool:
        """Gates + fine match + correction of one candidate chain
        (TryCloseLoop body, Mapper.cpp:984-1045)."""
        lp = self.cfg.loop
        sid = rec.state_id
        cov = np.asarray(coarse.covariance)
        self.events.loop_closure_check(
            f"scan {sid} vs chain[{chain[0]}..{chain[-1]}]: coarse "
            f"response {float(coarse.response):.3f}, var "
            f"({cov[0, 0]:.3f}, {cov[1, 1]:.3f})"
        )
        if not (
            float(coarse.response) > lp.loop_match_minimum_response_coarse
            and cov[0, 0] < lp.loop_match_maximum_variance_coarse
            and cov[1, 1] < lp.loop_match_maximum_variance_coarse
        ):
            return False
        fine = self._match(
            self.front_matcher, rec, chain,
            np.asarray(coarse.pose, np.float64), do_penalize=False,
        )
        # LoopMatchMinimumResponseFine gate (Mapper.cpp:1023) — distinct
        # from the link-match fine gate
        if float(fine.response) < lp.loop_match_minimum_response_fine:
            return False
        self.events.begin_loop_closure(
            f"closing loop: scan {sid}, fine response "
            f"{float(fine.response):.3f}"
        )
        rec.corrected_pose = np.asarray(fine.pose, np.float64)
        # update solver's copy of this node before correcting
        self.solver.set_node_pose(sid, rec.corrected_pose)
        self._link_chain(
            chain, sid, rec.corrected_pose,
            np.asarray(fine.covariance, np.float64),
            kind="loop",
        )
        self._correct_poses()
        self.loop_closures += 1
        self.events.end_loop_closure(
            f"loop closed ({self.loop_closures} total)"
        )
        return True

    # --- speculative front match (pipeline overlap) -------------------------
    def _dispatch_speculative(
        self, scan: Scan, odom_pose, sensor: str, last_rec: ScanRecord
    ) -> dict | None:
        """Dispatch the NEXT scan's front match before the current scan's
        loop search runs. Everything the match needs is already decided:
        the odometric HasMovedEnough gate, the propagated search center
        (last corrected pose ∘ odometry delta) and the running-buffer
        membership. The consumer re-validates all of it — if TryCloseLoop
        or an async harvest moved any pose in between, the speculation is
        dropped and a fresh synchronous match runs, so results are
        bit-identical to the sequential order."""
        st = self.sensors[sensor]
        nrec = self._make_record(
            scan, np.asarray(odom_pose, np.float64), sensor
        )
        delta = _np_rel(last_rec.odom_pose, nrec.odom_pose)
        nrec.corrected_pose = _np_compose(last_rec.corrected_pose, delta)
        if not self._moved_between(last_rec, nrec):
            return None
        running = list(st.running)
        if not running:
            return None
        ns = {self.scans[i].pts_laser.shape[0] for i in running}
        if len(ns) != 1:
            return None
        store = self._stores.get(next(iter(ns)))
        if store is None or any(
            self.scans[i].store_row < 0 for i in running
        ):
            return None
        poses, idx, lane_valid = self._chain_batch_indices([running])
        pend = self.front_matcher.match_chains_store_async(
            store.pts, store.valid, idx, poses, nrec.pts_laser,
            nrec.beam_valid, np.asarray(nrec.corrected_pose, np.float32),
            lane_valid=lane_valid,
        )
        return {
            "sensor": sensor,
            "rec": nrec,
            "pending": pend,
            "running": running,
            "center": nrec.corrected_pose.copy(),
            "poses": poses,
            "idx": idx,
            # raw BASE-frame odom pose: rec.odom_pose is sensor-frame
            # (offset-composed in _make_record), so comparing it against
            # the incoming base pose would never match for lasers with a
            # mount offset — the reuse check needs the pre-offset value
            "odom_base": np.asarray(odom_pose, np.float64).copy(),
            "ranges_bits": to_host(scan.ranges).astype(np.float32)
            .view(np.int32).copy(),
        }

    def _resolve_front_match(
        self, rec: ScanRecord, st: SensorState
    ) -> MatchResult | None:
        """Use the in-flight speculative match iff the world it was
        dispatched against is unchanged; None → caller matches fresh."""
        spec, self._spec = self._spec, None
        if spec is None or spec["sensor"] != rec.sensor:
            return None
        srec = spec["rec"]
        if srec is not rec and not (
            np.array_equal(srec.odom_pose, rec.odom_pose)
            # bitwise: pts may carry NaN/±inf beams
            and np.array_equal(
                srec.pts_laser.view(np.int32),
                rec.pts_laser.view(np.int32),
            )
        ):
            return None
        if not np.array_equal(spec["center"], rec.corrected_pose):
            return None
        if spec["running"] != list(st.running):
            return None
        poses, idx, _ = self._chain_batch_indices([spec["running"]])
        if not (
            np.array_equal(poses, spec["poses"])
            and np.array_equal(idx, spec["idx"])
        ):
            return None
        r = spec["pending"].resolve()
        return MatchResult(r.pose[0], r.response[0], r.covariance[0])

    # --- main entry ---------------------------------------------------------
    def process(self, scan: Scan, odom_pose, sensor: str | None = None,
                lookahead: tuple | None = None) -> bool:
        """Mapper::Process (Mapper.cpp:1999-2120). Returns True if the scan
        was accepted (moved enough) and integrated. ``sensor`` selects a
        registered laser (default: the one registered at construction).
        ``lookahead``: optional (next_scan, next_odom_pose) — enables the
        speculative front match (cfg.karto.speculative_front_match)."""
        sensor = sensor or self.default_sensor
        st = self.sensors[sensor]
        spec = self._spec
        if (spec is not None and spec["sensor"] == sensor
                and np.array_equal(
                    spec["odom_base"],
                    np.asarray(odom_pose, np.float64))
                and np.array_equal(  # bitwise: ranges may carry NaN/inf
                    to_host(scan.ranges).astype(np.float32).view(np.int32),
                    spec["ranges_bits"],
                )):
            # the speculative record was built from this very scan — reuse
            # the host-side conversion work
            rec = spec["rec"]
        else:
            rec = self._make_record(
                scan, np.asarray(odom_pose, np.float64), sensor
            )
        self._poll_correction()  # apply a finished async solve, if any

        # propagate last correction onto the odometric estimate (:2023-2024)
        if st.last_scan_id is not None:
            last = self.scans[st.last_scan_id]
            delta = _np_rel(last.odom_pose, rec.odom_pose)
            rec.corrected_pose = _np_compose(last.corrected_pose, delta)

        if not self._has_moved_enough(rec):
            return False

        cov = np.eye(3)
        if self.cfg.karto.use_scan_matching and st.last_scan_id is not None:
            with self.timer.stage("front_match"):
                res = self._resolve_front_match(rec, st)
                if res is None:
                    res = self._match(
                        self.front_matcher, rec, list(st.running),
                        rec.corrected_pose,
                    )
            rec.corrected_pose = np.asarray(res.pose, np.float64)
            cov = np.asarray(res.covariance, np.float64)

        rec.state_id = len(self.scans)
        rec.seq = len(st.scan_ids)
        self.scans.append(rec)
        st.scan_ids.append(rec.state_id)
        # upload the immutable points to the device store exactly once
        nb = rec.pts_laser.shape[0]
        if nb not in self._stores:
            self._stores[nb] = DeviceScanStore(nb, device=self.device)
        rec.store_row = self._stores[nb].append(rec.pts_laser, rec.beam_valid)
        self.solver.add_node(rec.state_id, rec.corrected_pose)
        if self.cfg.karto.use_scan_matching:
            with self.timer.stage("add_edges"):
                self._add_edges(rec, cov)
            # AddEdges may refine the pose via the weighted mean (:968-971)
            self.solver.set_node_pose(rec.state_id, rec.corrected_pose)
        self._add_running(rec)
        # overlap: the NEXT scan's front match goes onto the device now,
        # so it computes while the host gathers loop candidates and the
        # device runs the loop-coarse program for THIS scan
        self._spec = None
        if (lookahead is not None
                and self.cfg.karto.speculative_front_match
                and self.cfg.karto.use_scan_matching):
            with self.timer.stage("spec_dispatch"):
                self._spec = self._dispatch_speculative(
                    lookahead[0], lookahead[1], sensor, rec
                )
        if self.cfg.karto.do_loop_closing and self.cfg.karto.use_scan_matching:
            with self.timer.stage("try_close_loop"):
                self._try_close_loop(rec)
        st.last_scan_id = rec.state_id
        self._last_processed = rec.state_id
        return True

    def map_to_odom(self) -> np.ndarray:
        """The map→odom correction transform the reference publishes on TF
        (karto_slam.cc:447-473): corrected_pose ∘ odom_pose⁻¹ of the last
        processed scan (any sensor — the laser offset cancels), so that
        map_to_odom ∘ odom = corrected."""
        if self._last_processed is None:
            return np.zeros(3)
        rec = self.scans[self._last_processed]
        c, s = math.cos(rec.odom_pose[2]), math.sin(rec.odom_pose[2])
        inv = np.array(
            [
                -(c * rec.odom_pose[0] + s * rec.odom_pose[1]),
                -(-s * rec.odom_pose[0] + c * rec.odom_pose[1]),
                -rec.odom_pose[2],
            ]
        )
        return _np_compose(rec.corrected_pose, inv)

    def trajectory(self) -> np.ndarray:
        """Corrected BASE poses (sensor poses with each rec's rig offset
        removed; map→odom is offset-invariant, so only this boundary
        converts)."""
        self.flush()
        inv_offs = {
            name: _np_inv(st.offset) for name, st in self.sensors.items()
        }
        return np.asarray(
            [
                r.corrected_pose
                if self.sensors[r.sensor].laser.is_identity
                else _np_compose(r.corrected_pose, inv_offs[r.sensor])
                for r in self.scans
            ]
        ).reshape(-1, 3)

    def run(self, scans: Scan, odom_poses: np.ndarray) -> np.ndarray:
        """Replay a sequence; returns the indices of the ACCEPTED scans
        (SlamKarto laserCallback loop)."""
        # the whole sequence to the host ONCE; per-scan slicing is then free
        scans = Scan(**{f.name: to_host(getattr(scans, f.name))
                        for f in dataclasses.fields(Scan)})
        accepted = []
        T = scans.ranges.shape[0]
        for t in range(T):
            la = (
                (index_scan(scans, t + 1), odom_poses[t + 1])
                if t + 1 < T else None
            )
            if self.process(index_scan(scans, t), odom_poses[t],
                            lookahead=la):
                accepted.append(t)
        self.flush()
        return np.asarray(accepted)
