"""The megakernels' operation and byte counts, and the card's peaks.

The FP32 operation tables are those of the renderer's chip smoke test,
one entry a term of the kernel's work. A segment's count here takes only
the terms that do not depend on what the segment hit: the floor every
segment pays, the dense sweep over the plan's S sphere slots with each
slot's motion terms, the rect rows with their transform groups and the
medium rows. Shading, textures, MIS and path regeneration depend on the
hit mix and are left out, so the count is a lower bound and a share of
the roofline can read low but never high. The sweep term is the dense
algorithm's: every slot for every segment.
"""
from __future__ import annotations

# published peaks of one NVIDIA H100 SXM (dense, without sparsity)
FP32_PEAK = 67e12             # FLOP/s outside the tensor cores
HBM_PEAK = 3.35e12            # bytes/s

OPS_SLOT_STATIC = 20          # sweep slot: co 3, nb 5, cc 6, disc 2, rsqrt,
#                               sq, tn / tf 2
OPS_AXIS_MOTION = 2           # a motion FMA per axis the centres move along
OPS_SLOT_SHUTTER = 2          # per-slot motion fraction (no uniform shutter)
OPS_RECT = 6                  # (k - o_n) * 1/d_n, two plane-point FMAs
OPS_GROUP = {0: 0, 1: 17, 2: 3, 3: 17}   # object-space ray per transform
#                               group (rotated | translated << 1)
OPS_MEDIUM = {0: 38, 1: 32}   # sphere / box medium boundary, with log and
#                               FMA of the scatter distance (rotated form)
OPS_RECIPROCALS = 3           # 1/d of a surfaces segment
OPS_FLOOR = 32                # count 1, hit point 6, ddn + mirror 12,
#                               normalise 9, throughput 3, depth 1

# bytes a launch moves besides its tables: a lane reads its pixel row of
# 4 float32 (i, j, valid, pad) and writes 8 float32 output rows
LANE_BYTES = 4 * 4 + 8 * 4


def slot_ops(plan) -> int:
    """FP32 operations of one sphere slot in the dense sweep of `plan`."""
    ops = OPS_SLOT_STATIC
    axes = sum(map(bool, plan.moving_axes))
    if axes:
        ops += OPS_AXIS_MOTION * axes
        if not plan.uniform_time:
            ops += OPS_SLOT_SHUTTER
    return ops


def ops_per_segment(plan) -> float:
    """The FP32 operations every path segment of `plan` pays whatever it
    hits (see the module's docstring)."""
    ops = float(OPS_FLOOR)
    if plan.has_spheres:
        ops += plan.S * slot_ops(plan)
    if plan.surfaces:
        ops += OPS_RECIPROCALS + plan.R * OPS_RECT
        groups = {c >> 4: (c >> 2) & 3 for c in plan.rect_codes}
        ops += sum(OPS_GROUP[g] for g in groups.values())
        ops += sum(OPS_MEDIUM[c & 1] for c in plan.med_codes)
    return ops


def launch_bytes(plan, n_tiles: int, table_bytes: int) -> int:
    """Bytes one launch must move: each lane's pixel row in and output
    rows out, and the scene's tables read once."""
    return n_tiles * plan.T * LANE_BYTES + table_bytes


def least_seconds(ops: float, nbytes: float) -> tuple:
    """(seconds, bound) of work of `ops` FP32 operations moving `nbytes`:
    the larger of its compute and memory times at the peaks."""
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_PEAK
    return (t_ops, "fp32") if t_ops >= t_bytes else (t_bytes, "hbm")
