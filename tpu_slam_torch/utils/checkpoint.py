"""Checkpoint / resume of ``KartoSLAM`` and ``HectorSLAM`` — the port's
copy of ``tpu_slam/utils/checkpoint.py``, on the same ``.npz`` (+ JSON)
formats, so the port loads a snapshot that the JAX package wrote (and the
JAX package one that the port wrote).

The reference has no live checkpointing (SURVEY §5): `karto::Dataset` retains
every scan (Karto.h:6121) and the occupancy map is always rebuilt from the
stored scans (`karto_slam.cc:511-512`) — i.e. *the scan store is the
checkpoint*. This module formalizes that: serialize (scan points, validities,
odometric + corrected poses, graph edges) and the grid states; resume and map
regeneration come for free.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from tpu_slam_torch.models.karto.pipeline import KartoSLAM


def save_karto(slam: "KartoSLAM", path: str) -> None:
    """Snapshot the full mapper state (scans + graph + running buffer)."""
    recs = slam.scans
    edges = slam.solver._edges
    np.savez_compressed(
        path,
        pts=np.stack([r.pts_laser for r in recs]) if recs else np.zeros((0, 0, 2)),
        valid=np.stack([r.beam_valid for r in recs]) if recs else np.zeros((0, 0), bool),
        ranges=(
            np.stack([r.ranges for r in recs])
            if recs and recs[0].ranges is not None
            else np.zeros((0, 0), np.float32)
        ),
        bary=np.stack([r.bary_local for r in recs]) if recs else np.zeros((0, 2)),
        odom=np.stack([r.odom_pose for r in recs]) if recs else np.zeros((0, 3)),
        corrected=np.stack([r.corrected_pose for r in recs]) if recs else np.zeros((0, 3)),
        edge_i=np.asarray([e[0] for e in edges], np.int32),
        edge_j=np.asarray([e[1] for e in edges], np.int32),
        edge_mean=np.stack([e[2] for e in edges]) if edges else np.zeros((0, 3)),
        edge_info=np.stack([e[3] for e in edges]) if edges else np.zeros((0, 3, 3)),
        times=np.asarray([r.time for r in recs], np.float64),
        meta=np.frombuffer(
            json.dumps(
                {
                    "loop_closures": slam.loop_closures,
                    "adjacency": {
                        str(k): sorted(v) for k, v in slam.adjacency.items()
                    },
                    "scan_sensors": [r.sensor for r in recs],
                    "last_processed": slam._last_processed,
                    "default_sensor": slam.default_sensor,
                    "sensors": {
                        name: {
                            "offset": list(st.laser.offset),
                            "inverted": st.laser.inverted,
                            "running": list(st.running),
                            "last_scan_id": st.last_scan_id,
                        }
                        for name, st in slam.sensors.items()
                    },
                }
            ).encode(),
            dtype=np.uint8,
        ),
    )


def load_karto(slam: "KartoSLAM", path: str) -> None:
    """Restore a mapper snapshot into a freshly-constructed KartoSLAM; the
    scan store is uploaded to the mapper's device."""
    from collections import deque

    from tpu_slam_torch.models.karto.pipeline import (
        DeviceScanStore, LaserRig, ScanRecord, SensorState,
    )

    z = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(z["meta"]).decode())
    T = z["pts"].shape[0]
    if "sensors" not in meta:
        # legacy single-sensor snapshot (pre multi-sensor format): map the
        # old top-level running/last_scan_id onto one default sensor
        meta["default_sensor"] = "laser0"
        meta["scan_sensors"] = ["laser0"] * T
        meta["last_processed"] = meta.get("last_scan_id")
        rig = slam.sensors[slam.default_sensor].laser
        meta["sensors"] = {
            "laser0": {
                "offset": list(rig.offset),
                "inverted": rig.inverted,
                "running": [int(i) for i in z["running"]],
                "last_scan_id": meta.get("last_scan_id"),
            }
        }
    sensors = meta["scan_sensors"]
    times = z["times"] if "times" in z.files else np.zeros(T)
    slam.scans = [
        ScanRecord(
            state_id=i,
            pts_laser=z["pts"][i],
            beam_valid=z["valid"][i],
            bary_local=z["bary"][i],
            ranges=(
                z["ranges"][i]
                if "ranges" in z.files and z["ranges"].shape[0] == T
                else None
            ),
            odom_pose=z["odom"][i],
            corrected_pose=z["corrected"][i],
            time=float(times[i]),
            sensor=sensors[i],
        )
        for i in range(T)
    ]
    slam.default_sensor = meta["default_sensor"]
    slam.sensors = {}
    for name, s in meta["sensors"].items():
        rig = LaserRig(offset=tuple(s["offset"]), inverted=s["inverted"])
        slam.sensors[name] = SensorState(
            name=name,
            laser=rig,
            offset=np.asarray(rig.offset, np.float64),
            running=deque(int(i) for i in s["running"]),
            last_scan_id=s["last_scan_id"],
        )
    slam._stores = {}
    for rec in slam.scans:  # rebuild per-sensor scan lists + seq + store
        st = slam.sensors[rec.sensor]
        rec.seq = len(st.scan_ids)
        st.scan_ids.append(rec.state_id)
        nb = rec.pts_laser.shape[0]
        if nb not in slam._stores:
            slam._stores[nb] = DeviceScanStore(nb, device=slam.device)
        rec.store_row = slam._stores[nb].append(
            rec.pts_laser, rec.beam_valid
        )
    slam.adjacency = {
        int(k): set(v) for k, v in meta["adjacency"].items()
    }
    slam._last_processed = meta["last_processed"]
    slam.loop_closures = meta["loop_closures"]
    slam.solver.clear()
    for rec in slam.scans:
        slam.solver.add_node(rec.state_id, rec.corrected_pose)
    for k in range(z["edge_i"].shape[0]):
        slam.solver.add_constraint(
            int(z["edge_i"][k]), int(z["edge_j"][k]), z["edge_mean"][k],
            information=z["edge_info"][k],
        )


def save_hector(slam, path: str) -> None:
    """Snapshot a HectorSLAM instance (grids + pose), with the reference's
    keys: ``last_pose``, ``last_update`` (NaN before the first map
    update) and ``grid{i}``, each level a flat (size_y·size_x,) float32."""
    np.savez_compressed(
        path,
        last_pose=slam.last_pose.cpu().numpy(),
        last_update=(
            slam._last_map_update_pose
            if slam._last_map_update_pose is not None
            else np.full(3, np.nan)
        ),
        **{f"grid{i}": g.cpu().numpy() for i, g in enumerate(slam.grids)},
    )


def load_hector(slam, path: str) -> None:
    """Restore a Hector snapshot (the port's or the reference's) into a
    HectorSLAM of the same pyramid, on the mapper's device."""
    import torch

    z = np.load(path)
    f32 = dict(dtype=torch.float32, device=slam.device)
    slam.grids = [
        torch.as_tensor(np.asarray(z[f"grid{i}"], np.float32), **f32)
        for i in range(len(slam.grids))
    ]
    slam.last_pose = torch.as_tensor(
        np.asarray(z["last_pose"], np.float32), **f32)
    lu = z["last_update"]
    slam._last_map_update_pose = None if np.isnan(lu).any() else lu
