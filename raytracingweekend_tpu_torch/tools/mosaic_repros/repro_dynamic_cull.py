"""K13: the four feasibility probes of the dynamic-trip survivor sweep; the
port of tools/mosaic_repros/repro_dynamic_cull.py.

  A. out (8, 128) = tab[8 k : 8 k + 8], k = s[0] (a dynamic row slice)
  B. out (8, 128) = att[:, 128 k : 128 k + 128], k = s[1] (a dynamic
     column slice)
  C. ids (s0 - 2, s0, s1 + s2) written to scratch, then the sum, in id
     order, of the n = s[2] 8-row blocks of tab they name (a loop with a
     runtime trip count, each id read with a dynamic index)
  D. the ids of the rows c with votes[c, 0] > 0, ascending, filled with -1
     (ordered compaction)

The scalars s (4,) int32 live on the device and are read inside the
kernels (csrc/mosaic_repros.cu), never passed as launch arguments, so
nothing is constant; the plain versions read no scalar on the host either.
Where the TPU leaves a case undefined the port picks the interpreter's
answer or a fixed one: slice starts are clamped into the table, as
lax.dynamic_slice clamps them; C's id list has 8 entries, those it does
not write are 0, and it takes min(max(n, 0), 8) of them. D compacts with
one warp's __ballot_sync and a __popc prefix (csrc/megakernel.cu's
survivor-list form), so it takes at most 32 rows.
"""
from __future__ import annotations

import numpy as np
import torch

from ._common import LAUNCHES, Entry, make_row, need_cuda

S, LANES, ATT_COLS, N_IDS, MAX_VOTERS = 64, 128, 512, 8, 32
SCALARS = (3, 2, 3, 0)     # the repro's _SCALARS
VOTERS = (1, 4, 6)         # the repro's voting rows of its (8, 128) votes
FORMS = ("A dynamic-sublane-slice", "B dynamic-lane-slice",
         "C dynamic-trip-fori+smem", "D scalar-compaction-smem")
KERNEL_LAUNCHES = {f"K13 {f}": 0 for f in FORMS}
_KEYS = tuple(KERNEL_LAUNCHES)
_CULL = Entry("K13", "rtw_repro_cull_launch", 6, KERNEL_LAUNCHES)


def inputs(scalars=SCALARS, device="cpu") -> dict:
    """The repro's tables: s (4,) int32, tab = arange (64, 128), att =
    arange (8, 512), votes (8, 128) with 1.0 in column 0 of rows 1, 4, 6."""
    votes = np.zeros((8, LANES), np.float32)
    votes[list(VOTERS), 0] = 1.0
    arrays = dict(
        s=np.asarray(scalars, np.int32),
        tab=np.arange(S * LANES, dtype=np.float32).reshape(S, LANES),
        att=np.arange(8 * ATT_COLS, dtype=np.float32).reshape(8, ATT_COLS),
        votes=votes)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def expected(scalars=SCALARS) -> dict:
    """The repro's expected answers, generalised over the scalars (numpy,
    for slices in range and ids C reads that it wrote)."""
    a = inputs(scalars)
    tab, att = a["tab"].numpy(), a["att"].numpy()
    s0, s1, s2 = (int(v) for v in scalars[:3])
    ids = [s0 - 2, s0, s1 + s2][:s2]
    c = np.zeros((8, LANES), np.float32)
    for i in ids:
        c = c + tab[8 * i:8 * i + 8]
    d = np.full(8, -1, np.int32)
    d[:len(VOTERS)] = VOTERS
    return {FORMS[0]: tab[8 * s0:8 * s0 + 8],
            FORMS[1]: att[:, 128 * s1:128 * s1 + 128],
            FORMS[2]: c, FORMS[3]: d}


def _check(s: torch.Tensor, tab: torch.Tensor, rows_at_least: int,
           cols_at_least: int) -> None:
    if s.dtype != torch.int32 or s.dim() != 1 or s.numel() < 3:
        raise ValueError(f"scalars: int32 (>= 3,), got {s.dtype} "
                         f"{tuple(s.shape)}")
    if tab.dtype != torch.float32 or tab.dim() != 2 or \
            tab.shape[0] < rows_at_least or tab.shape[1] < cols_at_least:
        raise ValueError(f"table: float32 with >= {rows_at_least} rows and "
                         f">= {cols_at_least} columns, got {tab.dtype} "
                         f"{tuple(tab.shape)}")


def _block_rows(tab: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """tab[8 k : 8 k + 8] with the start clamped into the table, k a device
    scalar (no host read)."""
    start = (k.long() * 8).clamp(0, tab.shape[0] - 8)
    return tab.index_select(0, start + torch.arange(8, device=tab.device))


def sublane_slice_reference(s, tab):
    """A's plain version."""
    _check(s, tab, 8, 1)
    return _block_rows(tab, s[0])


def lane_slice_reference(s, att):
    """B's plain version."""
    _check(s, att, 1, 128)
    start = (s[1].long() * 128).clamp(0, att.shape[1] - 128)
    return att.index_select(1, start + torch.arange(128, device=att.device))


def fori_smem_reference(s, tab):
    """C's plain version: the 8 ids, and the sum over the first n in order
    (where() keeps the running sum past n)."""
    _check(s, tab, 8, 1)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    ids = torch.stack([s[0] - 2, s[0], s[1] + s[2]] + [zero] * (N_IDS - 3))
    n = s[2].clamp(0, N_IDS)
    acc = torch.zeros((8, tab.shape[1]), dtype=torch.float32,
                      device=tab.device)
    for i in range(N_IDS):
        acc = torch.where(i < n, acc + _block_rows(tab, ids[i]), acc)
    return acc


def _check_votes(votes: torch.Tensor) -> None:
    if votes.dtype != torch.float32 or votes.dim() != 2 or \
            not 1 <= votes.shape[0] <= MAX_VOTERS or votes.shape[1] < 1:
        raise ValueError(f"votes: float32 (rows <= {MAX_VOTERS}, cols), got "
                         f"{votes.dtype} {tuple(votes.shape)}")


def compaction_reference(votes):
    """D's plain version: voters sort before the rest, each in row order."""
    _check_votes(votes)
    rows = votes.shape[0]
    ids = torch.arange(rows, device=votes.device)
    key = torch.where(votes[:, 0] > 0, ids, ids + rows).sort().values
    return torch.where(key < rows, key, -1).int()


def _cull_kernel(probe: int, s, tab, out) -> torch.Tensor:
    need_cuda("K13", tab, out, *([] if s is None else [s]))
    _CULL.launch(_KEYS[probe], tab.get_device(), probe,
                 0 if s is None else s.data_ptr(), tab.data_ptr(),
                 out.data_ptr(), tab.shape[0], tab.shape[1])
    return out


def sublane_slice_kernel(s, tab):
    """A on the card."""
    _check(s, tab, 8, 1)
    return _cull_kernel(0, s, tab, torch.empty(
        (8, tab.shape[1]), dtype=torch.float32, device=tab.device))


def lane_slice_kernel(s, att):
    """B on the card."""
    _check(s, att, 1, 128)
    return _cull_kernel(1, s, att, torch.empty(
        (att.shape[0], 128), dtype=torch.float32, device=att.device))


def fori_smem_kernel(s, tab):
    """C on the card."""
    _check(s, tab, 8, 1)
    return _cull_kernel(2, s, tab, torch.empty(
        (8, tab.shape[1]), dtype=torch.float32, device=tab.device))


def compaction_kernel(votes):
    """D on the card: one warp."""
    _check_votes(votes)
    return _cull_kernel(3, None, votes, torch.empty(
        (votes.shape[0],), dtype=torch.int32, device=votes.device))


PROBES = ((sublane_slice_kernel, sublane_slice_reference, "tab"),
          (lane_slice_kernel, lane_slice_reference, "att"),
          (fori_smem_kernel, fori_smem_reference, "tab"),
          (compaction_kernel, compaction_reference, "votes"))


def probe(k: int, a: dict) -> torch.Tensor:
    """Probe k (0..3 = A..D) on the inputs `a`: the kernel for CUDA tensors,
    the plain version for CPU ones."""
    kern, ref, table = PROBES[k]
    fn = kern if a[table].is_cuda else ref
    return fn(a[table]) if k == 3 else fn(a["s"], a[table])


def reference(k: int, a: dict) -> torch.Tensor:
    _, ref, table = PROBES[k]
    return ref(a[table]) if k == 3 else ref(a["s"], a[table])


def _work(k: int, scalars) -> tuple:
    """(bytes, FP32 operations) the probe needs on these scalars: the
    scalars it reads, the table lanes it reads, its output."""
    out = 4 * 8 * LANES
    if k in (0, 1):
        return 4 + 2 * out, 0
    if k == 2:
        n = min(max(int(scalars[2]), 0), N_IDS)
        return 4 * 3 + (n + 1) * out, n * 8 * LANES
    return 4 * 8 + 4 * 8, 0       # votes' column 0 in, 8 ids out


def run(device="cuda", launches: int = LAUNCHES, outputs=None,
        scalars=SCALARS) -> list:
    """The four probes on the repro's inputs: one row each."""
    a = inputs(scalars, device)
    want_np = expected(scalars)
    rows = []
    for k, name in enumerate(FORMS):
        got = probe(k, a)
        want = reference(k, a)
        if outputs is not None:
            outputs[f"K13 {name}"] = (got, want)
        nbytes, ops = _work(k, scalars)
        rows.append(make_row(
            "K13", name, f"s {tuple(scalars)}; tab ({S}, {LANES}), att (8, "
            f"{ATT_COLS}), votes (8, {LANES}) f32",
            lambda k=k: probe(k, a), lambda k=k: reference(k, a), device,
            launches, nbytes=nbytes, ops=ops, got=got, want=want,
            library=(None, "none: no one PyTorch call slices, loops or "
                     "compacts by a device scalar without a host read"),
            as_expected=np.array_equal(got.cpu().numpy(), want_np[name])))
    return rows


def verdict(rows: list) -> list:
    return [f"{r['name']}: {'OK' if r['as_expected'] else 'WRONG VALUES'}"
            for r in rows]
