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
A slice start is the int32 start, wrapped as JAX's is (k * 8 or k * 128 in
int32), then clamped into the table, as lax.dynamic_slice clamps it:
where the wrapped start lies in the table that is the interpreter's
answer, and where it wraps to a negative value (the interpreter raises)
the clamp is the port's fixed choice. C's id list has 8 entries, those it
does not write are 0, and it takes min(max(n, 0), 8) of them, summed in
id order. D compacts with one warp's __ballot_sync and a __popc prefix
(csrc/megakernel.cu's survivor-list form), so it takes at most 32 rows.

On the card A-C run a thread a float4 of the output (a float where the
table's width is not a multiple of 4, or a pointer not 16-byte aligned:
the C entry picks by shape and alignment), so a thread reads the scalars,
then issues its table loads in one wave; C's threads load all n blocks
before adding them in id order. The wrappers check device, type, shape
and contiguity in one combined condition and allocate with `new_empty`.
"""
from __future__ import annotations

import numpy as np
import torch

from ._common import F32, LAUNCHES, Entry, make_row, refuse

S, LANES, ATT_COLS, N_IDS, MAX_VOTERS = 64, 128, 512, 8, 32
SCALARS = (3, 2, 3, 0)     # the repro's _SCALARS
VOTERS = (1, 4, 6)         # the repro's voting rows of its (8, 128) votes
FORMS = ("A dynamic-sublane-slice", "B dynamic-lane-slice",
         "C dynamic-trip-fori+smem", "D scalar-compaction-smem")
KERNEL_LAUNCHES = {f"K13 {f}": 0 for f in FORMS}
_KEYS = tuple(KERNEL_LAUNCHES)
_CULL = Entry("K13", "rtw_repro_cull_launch", 6, KERNEL_LAUNCHES)
I32 = torch.int32


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


def _start(k: torch.Tensor, size: int, extent: int) -> torch.Tensor:
    """The slice start of block k, an int32 device scalar (no host read):
    k * size in int32, wrapping as JAX's product does, then widened and
    clamped into [0, extent - size]."""
    return (k * size).long().clamp(0, extent - size)


def _block_rows(tab: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """tab[8 k : 8 k + 8], its start as `_start` makes it."""
    start = _start(k, 8, tab.shape[0])
    return tab.index_select(0, start + torch.arange(8, device=tab.device))


def sublane_slice_reference(s, tab):
    """A's plain version."""
    _check(s, tab, 8, 1)
    return _block_rows(tab, s[0])


def lane_slice_reference(s, att):
    """B's plain version."""
    _check(s, att, 1, 128)
    start = _start(s[1], 128, att.shape[1])
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


def _cull_kernel(probe: int, s, tab, rows_at_least: int,
                 cols_at_least: int) -> torch.Tensor:
    """Probe A, B or C (0..2) on the card: out (8, cols) or, for B,
    (rows, 128)."""
    ss, ts, dev = s.shape, tab.shape, tab.get_device()
    if not (dev >= 0 and s.get_device() == dev and s.dtype is I32
            and tab.dtype is F32 and len(ss) == 1 and ss[0] >= 3
            and len(ts) == 2 and ts[0] >= rows_at_least
            and ts[1] >= cols_at_least and s.is_contiguous()
            and tab.is_contiguous()):
        _check(s, tab, rows_at_least, cols_at_least)
        refuse("K13", tab, s)
    out = tab.new_empty((ts[0], LANES) if probe == 1 else (8, ts[1]))
    _CULL.launch(_KEYS[probe], dev, probe, s.data_ptr(), tab.data_ptr(),
                 out.data_ptr(), ts[0], ts[1])
    return out


def sublane_slice_kernel(s, tab):
    """A on the card: (8, cols), a thread a float4."""
    return _cull_kernel(0, s, tab, 8, 1)


def lane_slice_kernel(s, att):
    """B on the card: (rows, 128), a thread a float4."""
    return _cull_kernel(1, s, att, 1, LANES)


def fori_smem_kernel(s, tab):
    """C on the card: (8, cols), a thread a float4 of the sum."""
    return _cull_kernel(2, s, tab, 8, 1)


def compaction_kernel(votes):
    """D on the card: one warp."""
    vs, dev = votes.shape, votes.get_device()
    if not (dev >= 0 and votes.dtype is F32 and len(vs) == 2
            and 1 <= vs[0] <= MAX_VOTERS and vs[1] >= 1
            and votes.is_contiguous()):
        _check_votes(votes)
        refuse("K13", votes)
    out = votes.new_empty((vs[0],), dtype=I32)
    _CULL.launch(_KEYS[3], dev, 3, 0, votes.data_ptr(), out.data_ptr(),
                 vs[0], vs[1])
    return out


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
