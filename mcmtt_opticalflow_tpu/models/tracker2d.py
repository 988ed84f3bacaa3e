"""Per-camera 2D tracklet generation — the batched redesign of the reference's
CPSNWhere_Tracker2D (psn_where/PSNWhere_Tracker2D.cpp).

The reference loops over detections and trackers with per-object OpenCV
calls; here the entire per-frame step is one jitted function over fixed-
capacity struct-of-arrays state, and *cameras batch with vmap* — the OpenMP
per-camera fan-out (ref psn_where/PSNWhere.cpp:257-266, including its data
race on the shared results vector) becomes a leading array axis.

Stage structure mirrors the reference's Run (ref Tracker2D.cpp:251-373):

  1. detection validation by reconstructed height    (ref :705-715)
  2. grid corner extraction inside boxes             (ref :735-757)
  3. backward LK chain through the frame buffer with
     disparity-voting box estimation                 (ref :763-811, 455-554)
  4. forward LK of live trackers + box-chain cost    (ref :851-1025)
  5. assignment + gate validation + lifecycle        (ref :1038-1182)

Deviations (deliberate, for fixed-shape batched device programs):
  * fixed LK window from config instead of per-box windows (pyramid supplies
    the scale range);
  * match-validation gates (3D distance / height / duration,
    ref :1071-1077) are folded into the cost matrix as infinities *before*
    assignment instead of rejecting matches after;
  * the reference's random feature subsampling (ref :752) is replaced by
    deterministic grid spreading.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mcmtt_opticalflow_tpu.config import Tracker2DConfig
from mcmtt_opticalflow_tpu.geometry.tsai import TsaiCamera, image_to_world
from mcmtt_opticalflow_tpu.geometry.triangulation import triangulate_two_lines
from mcmtt_opticalflow_tpu.ops.features import detect_grid_features
from mcmtt_opticalflow_tpu.ops.hungarian import solve_assignment
from mcmtt_opticalflow_tpu.ops.lk import lk_track_prebuilt
from mcmtt_opticalflow_tpu.ops.pyramid import build_pyramid

_INF = jnp.inf


class Tracker2DState(NamedTuple):
    """Fixed-capacity per-camera tracker state.  All leaves may carry a
    leading camera axis for vmapped multi-camera stepping."""

    frames: jnp.ndarray        # [B, H, W] gray ring buffer, index -1 = newest
    # cached coarse pyramid levels of the ring frames, one ring per level
    # >= 1 ([B, H/2^l, W/2^l] each): each frame's pyramid builds ONCE at
    # ingest instead of twice per LK call (4 calls/frame)
    frames_lo: tuple           # tuple of [B, H/2^l, W/2^l] arrays
    frame_count: jnp.ndarray   # scalar int32
    trk_active: jnp.ndarray    # [T] bool
    trk_id: jnp.ndarray        # [T] int32
    trk_boxes: jnp.ndarray     # [T, B, 4] recent boxes, index 0 = current
    trk_time_start: jnp.ndarray  # [T] int32
    trk_time_end: jnp.ndarray  # [T] int32
    trk_feats: jnp.ndarray     # [T, F, 2]
    trk_feat_valid: jnp.ndarray  # [T, F] bool
    trk_location: jnp.ndarray  # [T, 3] last 3D ground location
    trk_height: jnp.ndarray    # [T] estimated person height (mm)
    next_id: jnp.ndarray       # scalar int32


class Track2DOutput(NamedTuple):
    """Per-frame tracklet output — the engine's stTrack2DResult
    (ref psn_where/PSNWhere_Types.h:200-209) as masked arrays."""

    ids: jnp.ndarray           # [T] int32 tracklet ids
    boxes: jnp.ndarray         # [T, 4]
    mask: jnp.ndarray          # [T] bool emitted this frame
    locations: jnp.ndarray     # [T, 3] 3D ground point of box bottom centre
    heights: jnp.ndarray       # [T] person height estimate
    det_boxes: jnp.ndarray     # [D, 4] validated detections
    det_mask: jnp.ndarray      # [D]
    cost_matrix: jnp.ndarray   # [D, T]


def init_tracker2d_state(cfg: Tracker2DConfig, height: int, width: int,
                         num_cameras: int | None = None) -> Tracker2DState:
    def z(shape, dtype=jnp.float32):
        if num_cameras is not None:
            shape = (num_cameras,) + shape
        return jnp.zeros(shape, dtype)

    t, f, b = cfg.max_trackers, cfg.max_features, cfg.backtrack_interval
    return Tracker2DState(
        frames=z((b, height, width)),
        frames_lo=tuple(
            z((b, height // 2 ** l, width // 2 ** l))
            for l in range(1, cfg.lk_pyramid_levels)),
        frame_count=z((), jnp.int32),
        trk_active=z((t,), bool),
        trk_id=z((t,), jnp.int32),
        trk_boxes=z((t, b, 4)),
        trk_time_start=z((t,), jnp.int32),
        trk_time_end=z((t,), jnp.int32),
        trk_feats=z((t, f, 2)),
        trk_feat_valid=z((t, f), bool),
        trk_location=z((t, 3)),
        trk_height=z((t,)),
        next_id=z((), jnp.int32),
    )


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------

def estimate_detection_height(cam: TsaiCamera, boxes: jnp.ndarray):
    """Height + ground location per box via two-line triangulation
    (ref EstimateDetectionHeight, Tracker2D.cpp:1195-1220): the top-centre
    pixel's back-projection line against the vertical line through the
    bottom-centre ground point."""
    bottom = jnp.stack([boxes[..., 0] + jnp.ceil(boxes[..., 2] / 2.0),
                        boxes[..., 1] + boxes[..., 3]], -1)
    top = bottom - jnp.stack([jnp.zeros_like(boxes[..., 3]),
                              boxes[..., 3]], -1)
    p11 = image_to_world(cam, top, 0.0)
    p12 = image_to_world(cam, top, 2000.0)
    p21 = image_to_world(cam, bottom, 0.0)
    p22 = p21 + jnp.asarray([0.0, 0.0, 2000.0], boxes.dtype)
    top_pt, _ = triangulate_two_lines(p11, p12, p21, p22)
    height = jnp.linalg.norm(top_pt - p21, axis=-1)
    return height, p21


# ---------------------------------------------------------------------------
# disparity voting (LocalSearchKLT)
# ---------------------------------------------------------------------------

def local_search_klt(pre_boxes, pre_feats, cur_feats, feat_valid, cfg):
    """Mode-seeking disparity vote, batched over boxes
    (ref LocalSearchKLT, Tracker2D.cpp:455-554).

    Args:
      pre_boxes:  [N, 4]
      pre_feats, cur_feats: [N, F, 2]
      feat_valid: [N, F]

    Returns (new_boxes [N, 4], inlier [N, F], moved [N]).
    `moved` False means the static-majority early-out fired (ref :493-496).
    """
    mv = cur_feats - pre_feats                       # [N, F, 2]
    disp = jnp.linalg.norm(mv, axis=-1)
    moving = feat_valid & (disp >= cfg.klt_min_movement)
    num_valid = jnp.sum(feat_valid, -1)
    num_moving = jnp.sum(moving, -1)
    moved = num_moving >= 0.5 * num_valid

    win = pre_boxes[:, 2] * cfg.klt_neighbor_window_ratio   # [N]
    # neighbour counts per axis over moving features: [N, F, F]
    def axis_mode(vals):
        diff = jnp.abs(vals[:, :, None] - vals[:, None, :])
        near = (diff < win[:, None, None]) & moving[:, None, :]
        cnt = jnp.sum(near, -1)
        cnt = jnp.where(moving, cnt, -1)
        best = jnp.argmax(cnt, -1)
        return jnp.take_along_axis(vals, best[:, None], 1)[:, 0]

    est = jnp.stack([axis_mode(mv[..., 0]), axis_mode(mv[..., 1])], -1)  # [N,2]
    inlier = moving & (jnp.linalg.norm(mv - est[:, None, :], axis=-1)
                       < win[:, None])
    new_boxes = pre_boxes.at[:, 0:2].add(est)
    new_boxes = jnp.where(moved[:, None], new_boxes, pre_boxes)
    inlier = jnp.where(moved[:, None], inlier, jnp.zeros_like(inlier))
    return new_boxes, inlier, moved


def _box_center(b):
    return jnp.stack([b[..., 0] + jnp.ceil(b[..., 2] / 2.0),
                      b[..., 1] + jnp.ceil(b[..., 3] / 2.0)], -1)


def _box_overlap(b1, b2):
    """bool overlap test (ref PSN_Rect::overlap, PSNWhere_Types.h:161-164)."""
    ox = (jnp.maximum(b1[..., 0] + b1[..., 2], b2[..., 0] + b2[..., 2])
          - jnp.minimum(b1[..., 0], b2[..., 0])) < b1[..., 2] + b2[..., 2]
    oy = (jnp.maximum(b1[..., 1] + b1[..., 3], b2[..., 1] + b2[..., 3])
          - jnp.minimum(b1[..., 1], b2[..., 1])) < b1[..., 3] + b2[..., 3]
    return ox & oy


def _box_distance(b1, b2):
    """descriptor distance (ref PSN_Rect::distance, PSNWhere_Types.h:165-170)."""
    d1 = jnp.stack([b1[..., 0] + b1[..., 2] / 2, b1[..., 1] + b1[..., 3] / 2,
                    b1[..., 2]], -1)
    d2 = jnp.stack([b2[..., 0] + b2[..., 2] / 2, b2[..., 1] + b2[..., 3] / 2,
                    b2[..., 2]], -1)
    return (jnp.linalg.norm(d1 - d2, axis=-1)
            / jnp.minimum(b1[..., 2], b2[..., 2]))


def _overlap_area(b1, b2):
    ow = (jnp.minimum(b1[..., 0] + b1[..., 2], b2[..., 0] + b2[..., 2])
          - jnp.maximum(b1[..., 0], b2[..., 0]))
    oh = (jnp.minimum(b1[..., 1] + b1[..., 3], b2[..., 1] + b2[..., 3])
          - jnp.maximum(b1[..., 1], b2[..., 1]))
    return jnp.maximum(ow, 0.0) * jnp.maximum(oh, 0.0)


def _box_matching_cost(b1, b2):
    """(ref BoxMatchingCost, Tracker2D.cpp:615-630)"""
    nom = jnp.sum((_box_center(b1) - _box_center(b2)) ** 2, -1)
    den = ((b1[..., 2] + b2[..., 2]) / 2.0) ** 2
    return nom / jnp.maximum(den, 1e-6)


# ---------------------------------------------------------------------------
# the per-frame step
# ---------------------------------------------------------------------------

def tracker2d_step(state: Tracker2DState,
                   gray: jnp.ndarray,
                   det_boxes: jnp.ndarray,
                   det_mask: jnp.ndarray,
                   cam: TsaiCamera,
                   frame_idx: jnp.ndarray,
                   cfg: Tracker2DConfig):
    """One camera, one frame.  vmap over the leading axis for multi-camera.

    Args:
      state:     Tracker2DState (single camera slice).
      gray:      [H, W] float gray frame in [0, 1].
      det_boxes: [D, 4] padded detections (x, y, w, h).
      det_mask:  [D] bool.
      cam:       TsaiCamera for this camera.
      frame_idx: scalar int32.

    Returns (new_state, Track2DOutput).
    """
    bql = cfg.backtrack_interval
    n_trk = cfg.max_trackers
    n_det = det_boxes.shape[0]
    n_feat = cfg.max_features

    # ---- frame buffer push ------------------------------------------------
    frames = jnp.concatenate([state.frames[1:], gray[None]], axis=0)
    # the new frame's pyramid builds ONCE here; coarse levels ride their
    # own ring buffers so every LK call below reads cached levels
    g_pyr = build_pyramid(gray, cfg.lk_pyramid_levels)
    frames_lo = tuple(
        jnp.concatenate([old[1:], g_pyr[l + 1][None]], axis=0)
        for l, old in enumerate(state.frames_lo))
    frame_count = jnp.minimum(state.frame_count + 1, bql)

    def pyr_at(i):
        return [frames[i]] + [lo[i] for lo in frames_lo]

    # ---- 1. detection validation by height (ref :705-715) ------------------
    heights, locations = estimate_detection_height(cam, det_boxes)
    det_valid = (det_mask & (heights >= cfg.min_height_mm)
                 & (heights <= cfg.max_height_mm))

    # ---- 2. feature extraction (ref :735-757) ------------------------------
    grid = int(n_feat ** 0.5)
    det_feats, det_feat_valid = detect_grid_features(
        gray, det_boxes, det_valid, grid=grid, sub=2,
        quality=cfg.feature_quality_level)
    enough = jnp.sum(det_feat_valid, -1) >= cfg.min_features
    det_valid = det_valid & enough

    # ---- 3. backward LK chain (ref :763-811) -------------------------------
    # det_hist[j] = box j frames back; chain_len counts successful steps + 1
    det_hist = jnp.zeros((n_det, bql, 4), det_boxes.dtype)
    det_hist = det_hist.at[:, 0].set(det_boxes)
    chain_len = jnp.ones((n_det,), jnp.int32)
    cur_feats = det_feats
    cur_valid = det_feat_valid
    cur_box = det_boxes
    alive = det_valid
    first_inliers = det_feats
    first_valid = det_feat_valid
    for j in range(1, bql):
        have_frame = frame_count > j
        pts = cur_feats.reshape(-1, 2)
        act = (cur_valid & alive[:, None]).reshape(-1)
        tracked, status, _ = lk_track_prebuilt(
            pyr_at(bql - j), pyr_at(bql - 1 - j), pts,
            window=cfg.lk_window,
            iterations=cfg.lk_iterations, active=act)
        back_feats = tracked.reshape(n_det, n_feat, 2)
        back_ok = status.reshape(n_det, n_feat) & cur_valid
        new_box, inlier, moved = local_search_klt(
            cur_box, cur_feats, back_feats, back_ok, cfg)
        # note inversion: here "cur -> back" disparity, box moves backward
        step_ok = (alive & have_frame & moved
                   & (jnp.sum(inlier, -1) >= cfg.min_features))
        if j == 1:
            # keep the current-frame inlier features (ref :792-800)
            first_inliers = cur_feats
            first_valid = jnp.where(step_ok[:, None], inlier, det_feat_valid)
        det_hist = det_hist.at[:, j].set(
            jnp.where(step_ok[:, None], new_box, 0.0))
        chain_len = jnp.where(step_ok, chain_len + 1, chain_len)
        cur_feats = jnp.where(step_ok[:, None, None], back_feats, cur_feats)
        cur_valid = jnp.where(step_ok[:, None], inlier, cur_valid)
        cur_box = jnp.where(step_ok[:, None], new_box, cur_box)
        alive = step_ok  # chain breaks stay broken (ref `break`, :788)

    # ---- 4. forward LK of live trackers (ref :851-1025) --------------------
    t_pts = state.trk_feats.reshape(-1, 2)
    t_act = (state.trk_feat_valid & state.trk_active[:, None]).reshape(-1)
    t_tracked, t_status, _ = lk_track_prebuilt(
        pyr_at(bql - 2), pyr_at(bql - 1), t_pts,
        window=cfg.lk_window,
        iterations=cfg.lk_iterations, active=t_act)
    trk_curr_feats = t_tracked.reshape(n_trk, n_feat, 2)
    trk_track_ok = t_status.reshape(n_trk, n_feat) & state.trk_feat_valid
    trk_enough = jnp.sum(trk_track_ok, -1) >= cfg.min_features
    trk_prev_box = state.trk_boxes[:, 0]
    trk_new_box, trk_inlier, _ = local_search_klt(
        trk_prev_box, state.trk_feats, trk_curr_feats, trk_track_ok, cfg)
    trk_predict_ok = state.trk_active & trk_enough

    # shift tracker box history and place predicted current box at index 0
    trk_boxes = jnp.concatenate(
        [trk_new_box[:, None], state.trk_boxes[:, :-1]], axis=1)

    # ---- cost matrix (ref :928-1025) ---------------------------------------
    trk_len = jnp.where(state.trk_active,
                        state.trk_time_end - state.trk_time_start + 2, 0)
    # +2: duration + the freshly predicted box, matching the reference's
    # boxes.size() after push_back
    compare_len = jnp.minimum(
        jnp.minimum(chain_len[:, None], trk_len[None, :]), bql)  # [D, T]

    d_hist = det_hist[:, None, :, :]            # [D, 1, B, 4]
    t_hist = trk_boxes[None, :, :, :]           # [1, T, B, 4]
    j_idx = jnp.arange(bql)[None, None, :]
    in_window = j_idx < compare_len[:, :, None]  # [D, T, B]
    pair_cost = _box_matching_cost(t_hist, d_hist)
    gate = (_box_overlap(d_hist, t_hist)
            & (_box_distance(d_hist, t_hist) <= cfg.max_box_distance)
            & (_overlap_area(d_hist, t_hist)
               / jnp.maximum(jnp.minimum(d_hist[..., 2] * d_hist[..., 3],
                                         t_hist[..., 2] * t_hist[..., 3]),
                             1e-6) >= cfg.min_overlap_ratio)
            & (jnp.linalg.norm(_box_center(d_hist) - _box_center(t_hist),
                               axis=-1)
               <= cfg.max_box_center_diff_ratio
               * jnp.maximum(d_hist[..., 2], t_hist[..., 2])))
    ok_window = jnp.all(gate | ~in_window, axis=-1)
    mean_cost = (jnp.sum(jnp.where(in_window, pair_cost, 0.0), -1)
                 / jnp.maximum(compare_len, 1))

    overlap_now = _box_overlap(det_boxes[:, None], trk_new_box[None, :])
    # hard gates folded in before assignment (ref :937, :1071-1077)
    gate3d = (jnp.linalg.norm(locations[:, None] - state.trk_location[None],
                              axis=-1) <= cfg.max_detection_distance_mm)
    gate_h = (jnp.abs(heights[:, None] - state.trk_height[None])
              <= cfg.max_height_difference_mm)
    gate_len = (trk_len[None, :] - 1) <= cfg.max_tracklet_length
    feasible = (det_valid[:, None] & trk_predict_ok[None, :] & overlap_now
                & ok_window & gate3d & gate_h & gate_len)
    cost = jnp.where(feasible, mean_cost, _INF)

    # optical-flow majority veto (ref :981-1022): per detection, count the
    # tracked features of each overlapping tracker inside the det box
    fx = trk_curr_feats[None, :, :, 0]
    fy = trk_curr_feats[None, :, :, 1]
    db = det_boxes[:, None, None, :]
    inside = ((fx >= db[..., 0]) & (fx < db[..., 0] + db[..., 2])
              & (fy >= db[..., 1]) & (fy < db[..., 1] + db[..., 3])
              & trk_track_ok[None, :, :] & overlap_now[:, :, None]
              & trk_predict_ok[None, :, None])
    counts = jnp.sum(inside, axis=-1)                 # [D, T]
    total = jnp.sum(counts, axis=-1)                  # [D]
    major = jnp.max(counts, axis=-1)
    veto = (total > 0) & (major <= cfg.min_flow_majority_ratio * total)
    cost = jnp.where(veto[:, None], _INF, cost)

    # ---- 5. assignment (ref :1038-1107) ------------------------------------
    match_col, match_cost = solve_assignment(
        cost, det_valid, trk_predict_ok)
    matched_det = match_col >= 0                                   # [D]
    # tracker -> detection inverse map (dead writes routed out of bounds)
    det_of_trk = jnp.full((n_trk,), -1, jnp.int32)
    det_of_trk = det_of_trk.at[jnp.where(matched_det, match_col, n_trk)] \
        .set(jnp.arange(n_det, dtype=jnp.int32), mode="drop")
    trk_matched = det_of_trk >= 0
    safe_det = jnp.where(trk_matched, det_of_trk, 0)

    # ---- tracker update (ref :1082-1106) -----------------------------------
    upd_box = det_boxes[safe_det]
    trk_boxes = trk_boxes.at[:, 0].set(
        jnp.where(trk_matched[:, None], upd_box, trk_boxes[:, 0]))
    trk_time_end = jnp.where(trk_matched, frame_idx, state.trk_time_end)
    trk_feats_new = jnp.where(trk_matched[:, None, None],
                              first_inliers[safe_det], trk_curr_feats)
    trk_feat_valid_new = jnp.where(trk_matched[:, None],
                                   first_valid[safe_det],
                                   trk_inlier & trk_track_ok)
    trk_location = jnp.where(trk_matched[:, None], locations[safe_det],
                             state.trk_location)
    trk_height = jnp.where(trk_matched, heights[safe_det], state.trk_height)

    # unmatched trackers terminate (ref :1152-1164)
    trk_active = trk_matched

    # ---- tracker generation for unmatched detections (ref :1112-1147) ------
    new_det = det_valid & ~matched_det                   # [D]
    free = ~trk_active                                   # [T]
    # rank new detections and free slots; k-th new det takes k-th free slot
    det_rank = jnp.cumsum(new_det.astype(jnp.int32)) - 1     # [D]
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1       # [T]
    slot_of_rank = jnp.full((n_trk,), -1, jnp.int32)
    slot_of_rank = slot_of_rank.at[jnp.where(free, free_rank, n_trk)].set(
        jnp.arange(n_trk, dtype=jnp.int32), mode="drop")
    num_free = jnp.sum(free)
    placed = new_det & (det_rank < num_free)
    target_slot = jnp.where(placed, slot_of_rank[jnp.clip(det_rank, 0,
                                                          n_trk - 1)], -1)

    is_new = jnp.zeros((n_trk,), bool)
    src_det = jnp.zeros((n_trk,), jnp.int32)
    is_new = is_new.at[jnp.where(placed, target_slot, n_trk)].set(
        True, mode="drop")
    src_det = src_det.at[jnp.where(placed, target_slot, n_trk)].set(
        jnp.arange(n_det, dtype=jnp.int32), mode="drop")

    new_ids = state.next_id + jnp.cumsum(is_new.astype(jnp.int32)) - 1
    trk_id = jnp.where(is_new, new_ids, state.trk_id)
    next_id = state.next_id + jnp.sum(is_new)

    trk_boxes = jnp.where(is_new[:, None, None],
                          jnp.zeros_like(trk_boxes), trk_boxes)
    trk_boxes = trk_boxes.at[:, 0].set(
        jnp.where(is_new[:, None], det_boxes[src_det], trk_boxes[:, 0]))
    trk_time_start = jnp.where(is_new, frame_idx, state.trk_time_start)
    trk_time_end = jnp.where(is_new, frame_idx, trk_time_end)
    trk_feats_new = jnp.where(is_new[:, None, None], first_inliers[src_det],
                              trk_feats_new)
    trk_feat_valid_new = jnp.where(is_new[:, None], first_valid[src_det],
                                   trk_feat_valid_new)
    trk_location = jnp.where(is_new[:, None], locations[src_det], trk_location)
    trk_height = jnp.where(is_new, heights[src_det], trk_height)
    trk_active = trk_active | is_new

    new_state = Tracker2DState(
        frames=frames, frames_lo=frames_lo, frame_count=frame_count,
        trk_active=trk_active, trk_id=trk_id, trk_boxes=trk_boxes,
        trk_time_start=trk_time_start, trk_time_end=trk_time_end,
        trk_feats=trk_feats_new, trk_feat_valid=trk_feat_valid_new,
        trk_location=trk_location, trk_height=trk_height, next_id=next_id)

    out = Track2DOutput(
        ids=trk_id, boxes=trk_boxes[:, 0], mask=trk_active,
        locations=trk_location, heights=trk_height,
        det_boxes=det_boxes, det_mask=det_valid, cost_matrix=cost)
    return new_state, out


def make_tracker2d_step(cfg: Tracker2DConfig, multi_camera: bool = False):
    """Build a jitted per-frame step.

    multi_camera=False: (state, gray[H,W], det[D,4], mask[D], cam, frame_idx)
    multi_camera=True:  leaves carry a leading camera axis and cam is a
    stacked TsaiCamera — the vmap replaces the reference's OpenMP
    per-camera loop (ref psn_where/PSNWhere.cpp:257-266).
    """
    @jax.named_scope("tracker2d")
    def tracker2d(state, gray, det_boxes, det_mask, cam, frame_idx):
        return tracker2d_step(state, gray, det_boxes, det_mask, cam,
                              frame_idx, cfg)

    if multi_camera:
        tracker2d = jax.vmap(tracker2d, in_axes=(0, 0, 0, 0, 0, None))
    return jax.jit(tracker2d)
