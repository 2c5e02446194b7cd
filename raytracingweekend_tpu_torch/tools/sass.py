"""The SASS of a kernel library build (ops/_build.py): each megakernel,
sweep twin, microbenchmark and Mosaic repro instantiation's name, its
registers, spills and stack from nvcc's ptxas report, the sphere sweeps'
slot loops, counted instruction by instruction, and the surfaces
kernels' rect and light loops with their MUFU and load counts
(`cuobjdump -sass` from the CUDA toolkit beside nvcc). chip_smoke.py's
phase 2 prints them for the kernels' build; tools/culled_ab.py for each
build it times.
"""
from __future__ import annotations

import os
import re
import subprocess

from ..ops import _build


def kernel_name(mangled: str):
    """'<kAxes,kUniformTime>', 'surfaces<kAxes,kUniformTime,kFeat>',
    'culled<kMoving,kUniformTime>' or
    'culled_surfaces<kMoving,kUniformTime,kTex>' of a mangled mega_kernel /
    mega_kernel_surfaces / mega_kernel_culled / mega_kernel_culled_surfaces
    instantiation (kAxes: the dense slot loop's moving-axis mask,
    mk.sweep_axes; kFeat: the surfaces form's features, mk.F_*; a build
    before the forms names kTex there), 'twin<kExt>' of the sweep twin's
    (K8), 'k9<body,unit>' of the microbenchmark's (K9),
    'k7<kAxes,kUniform>' of the closest sphere hit's (K7) and
    'repro:<name>' of the Mosaic repros' (K10-K14), else None."""
    repro = re.search(r"repro_(\w+?)_kernel(?:IL[bi](\d+)E)?", mangled)
    if repro:
        return (f"repro:{repro.group(1)}"
                + (f"<{repro.group(2)}>" if repro.group(2) else ""))
    twin = re.search(r"sweep_twin_kernelILb(\d)E", mangled)
    if twin:
        return f"twin<{twin.group(1)}>"
    bench = re.search(r"microbench_kernelILi(\d)ELi(\d)E", mangled)
    if bench:
        return f"k9<{bench.group(1)},{bench.group(2)}>"
    k7 = re.search(r"hit_spheres_kernelILi(\d)ELb(\d)E", mangled)
    if k7:
        return f"k7<{k7.group(1)},{k7.group(2)}>"
    m = re.search(
        r"mega_kernel(_surfaces|_culled_surfaces|_culled)?I((?:L[ib]\d+E)+)E",
        mangled)
    if not m:
        return None
    args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2)))
    return f"{(m.group(1) or '_')[1:]}<{args}>"


def sweep_sass(lib: str) -> dict:
    """SASS instructions per sphere slot of each megakernel and sweep twin
    instantiation's sweep loop (`cuobjdump -sass` of the built library):
    the innermost loop with the most MUFU.RSQ (one per slot; nvcc unrolls
    the sweep) and no warp vote (the culled kernel's cluster visits vote;
    its slot loops do not), from its branch target to its backward
    branch. A culled kernel has two: the broadcast loop, inside the visit
    loop (which ballots), and the compacted one, inside the loop over the
    needing lanes (which reduces with REDUX and does not ballot), listed as
    '<name> compacted'.
    Returns {name: (instructions, slots, FFMA, FMUL, FADD, LDS)} (LDS:
    the shared-memory loads), the compacted loops with a seventh item: the
    instructions of the needing-lane loop outside its slot loops
    (shuffles, REDUX, merge). Split FMUL / FADD pairs where the plain
    version fuses show as FMUL and FADD counts above the culled sphere
    kernel's."""
    return slot_loops(cuobjdump(lib))


def cuobjdump(lib: str) -> str:
    """`cuobjdump -sass` of the library at `lib` (the toolkit's, beside
    nvcc)."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def slot_loops(text: str) -> dict:
    """`sweep_sass` of the SASS listing `text`."""
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = kernel_name(func.split(None, 1)[0])
        if name is None or name.startswith(("k7", "k9", "repro:")):
            continue
        ins, loops = _loops(func)

        def has(a, b, pat):
            return any(re.match(pat, op) for _, op in ins[a:b + 1])

        def outer(a, b):
            """The smallest loop around (a, b), or None."""
            return min(((c, d) for c, d in loops
                        if c <= a and b <= d and (c, d) != (a, b)),
                       key=lambda cd: cd[1] - cd[0], default=None)

        def pick(cands):
            return max(((sum("MUFU.RSQ" in op for _, op in ins[a:b + 1]),
                         b - a + 1, a) for a, b in cands), default=(0, 0, 0))

        def counts(best):
            ops = [op.split()[0] for _, op in ins[best[2]:best[2] + best[1]]
                   if op.split()]
            return (best[1], best[0],
                    *(sum(o.startswith(k) for o in ops)
                      for k in ("FFMA", "FMUL", "FADD", "LDS")))

        inner = [(a, b) for a, b in loops
                 if not any(a <= c and d <= b and (c, d) != (a, b)
                            for c, d in loops)
                 and not has(a, b, r"(VOTE|REDUX)")]
        compact = [(a, b) for a, b in inner
                   if (o := outer(a, b)) and has(*o, r"REDUX")
                   and not has(*o, r"VOTE")]
        out[name] = counts(pick([lp for lp in inner if lp not in compact]))
        if compact:
            best = pick(compact)
            o = outer(best[2], best[2] + best[1] - 1)
            lane = (o[1] - o[0] + 1) - sum(
                b - a + 1 for a, b in inner if o[0] <= a and b <= o[1])
            out[f"{name} compacted"] = (*counts(best), lane)
    return out


def _loops(func: str) -> tuple:
    """The instructions [(address, text)] of one function's SASS and its
    loops [(first, last)]: each backward branch and its target, as
    indices into the instructions."""
    ins = [(int(a, 16), op) for a, op in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", func)]
    addr = {a: k for k, (a, _) in enumerate(ins)}
    loops = []
    for k, (a, op) in enumerate(ins):
        br = re.search(r"\bBRA\s+(0x[0-9a-f]+)", op)
        if br and int(br.group(1), 16) <= a:
            loops.append((addr[int(br.group(1), 16)], k))
    return ins, loops


def k7_loops(text: str) -> dict:
    """K7's slot loop in each instantiation of the SASS listing `text`:
    the innermost loop with the most MUFU.RSQ (the root's seed, one a
    ray-slot pair; a thread sweeps several rays, the loop is unrolled and
    has a remainder loop beside it, both inside the loop over chunks),
    counted per pair:
    instructions, FFMA, FMUL, FADD, LDS (shared loads, a slot's serving
    every ray of the thread) and BRA, with the pairs a loop iteration.
    {k7<kAxes,kUniform>: dict}."""
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = kernel_name(func.split(None, 1)[0])
        if name is None or not name.startswith("k7"):
            continue
        ins, loops = _loops(func)
        inner = [(a, b) for a, b in loops
                 if not any(a <= c and d <= b and (c, d) != (a, b)
                            for c, d in loops)]
        best = max(((sum("MUFU.RSQ" in op for _, op in ins[a:b + 1]), a, b)
                    for a, b in inner), default=(0, 0, 0))
        pairs, a, b = best
        if not pairs:
            continue
        ops = [o.split(".")[0] for o in _opcodes(ins[a:b + 1])]
        count = {k: ops.count(k) / pairs
                 for k in ("FFMA", "FMUL", "FADD", "LDS", "BRA")}
        out[name] = dict(sass_per_pair=(b - a + 1) / pairs,
                         pairs_an_iteration=pairs, **count)
    return out


def surface_loops(text: str) -> dict:
    """Each surfaces instantiation's (dense and culled) counts in the SASS
    listing `text`: its instructions; MUFU by function, and its loads
    from shared memory (LDS), through generic addresses (LD), from global
    memory (LDG) and local memory (LDL, with STL: spills and stack); and
    its innermost loops over rects and lights with their instructions:
    a rect loop reads shared memory, tests bounds (four or more FSETP),
    takes no MUFU, no min / max (the culled kernels' slab loops) and no
    warp vote or shuffle; the light loop takes roots and divides
    (MUFU.RSQ and MUFU.RCP) and reads shared memory. The redesigned
    kernel's rect loops run one row an iteration (`rect_run`, unroll 1),
    its light loop one light. {name: dict}."""
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = kernel_name(func.split(None, 1)[0])
        if name is None or "surfaces" not in name:
            continue
        ins, loops = _loops(func)
        ops = _opcodes(ins)
        inner = [(a, b) for a, b in loops
                 if not any(a <= c and d <= b and (c, d) != (a, b)
                            for c, d in loops)]
        rects, lights = [], []
        for a, b in sorted(set(inner)):
            body = _opcodes(ins[a:b + 1])
            mufu = [o for o in body if o.startswith("MUFU")]
            n_fsetp = sum(o.startswith("FSETP") for o in body)
            has_lds = any(o.startswith("LDS") for o in body)
            if ("MUFU.RSQ" in mufu and "MUFU.RCP" in mufu and has_lds):
                lights.append(b - a + 1)
            elif (not mufu and has_lds and n_fsetp >= 4
                  and not any(o.startswith(("FMNMX", "VOTE", "REDUX",
                                            "SHFL")) for o in body)):
                rects.append(b - a + 1)
        kinds = sorted({o.split(".")[1] for o in ops
                        if o.startswith("MUFU.")})
        out[name] = dict(
            instructions=len(ops),
            MUFU={k: sum(o.startswith(f"MUFU.{k}") for o in ops)
                  for k in kinds},
            LDS=sum(o.startswith("LDS") for o in ops),
            LD=sum(o == "LD" or o.startswith("LD.") for o in ops),
            LDG=sum(o.startswith("LDG") for o in ops),
            LDL=sum(o.startswith("LDL") for o in ops),
            STL=sum(o.startswith("STL") for o in ops),
            rect_loops=rects, light_loops=lights)
    return out


def repro_ops(text: str, repro: str) -> dict:
    """The opcode counts of each instantiation of one Mosaic repro kernel
    (`repro_<repro>[_grid]_kernel`) in the SASS listing `text`: its
    instructions, its backward branches (loops), and its shuffles (SHFL),
    float min / max (FMNMX), barriers (BAR), warp syncs (WARPSYNC, NOP
    excluded), global loads and stores (LDG, STG), shared loads and
    stores (LDS, STS), local loads and stores (LDL, STL: the stack),
    atomics (ATOM, RED), rounding (FRND: a ceil), float compares (FSETP)
    and integer-to-float conversions (I2F), and the global loads issued
    before the first FMNMX (`LDG_before_use`: the loads in flight at
    once before the reduction's first wait). {name: dict}."""
    keys = ("SHFL", "FMNMX", "BAR", "WARPSYNC", "LDG", "STG", "LDS", "STS",
            "LDL", "STL", "ATOM", "RED", "FRND", "FSETP", "I2F")
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = kernel_name(func.split(None, 1)[0])
        if name is None or name.split("<")[0] not in (
                f"repro:{repro}", f"repro:{repro}_grid"):
            continue
        ins, loops = _loops(func)
        ops = [o for o in _opcodes(ins) if o != "NOP"]
        heads = [o.split(".")[0] for o in ops]
        first = heads.index("FMNMX") if "FMNMX" in heads else len(heads)
        out[name] = dict(instructions=len(ops), loops=len(loops),
                         **{k: heads.count(k) for k in keys},
                         LDG_before_use=heads[:first].count("LDG"))
    return out


def _opcodes(ins) -> list:
    """The opcodes of SASS instructions, predicates (@P0, @!P1) dropped."""
    ops = []
    for _, op in ins:
        words = [w for w in op.split() if not w.startswith("@")]
        if words:
            ops.append(words[0])
    return ops


def registers(log: str) -> dict:
    """{instantiation: (registers, spill store bytes, stack bytes)} from
    nvcc's ptxas report `log` (-Xptxas -v; None where it says nothing)."""
    rows = {}
    for m in re.finditer(r"Compiling entry function '([^']*)'(.*?)Used "
                         r"(\d+) registers", log, re.S):
        spill = re.search(r"(\d+) bytes spill stores", m.group(2))
        stack = re.search(r"(\d+) bytes stack frame", m.group(2))
        name = kernel_name(m.group(1)) or m.group(1)
        rows[name] = (int(m.group(3)),
                      int(spill.group(1)) if spill else None,
                      int(stack.group(1)) if stack else None)
    return rows
