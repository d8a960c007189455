"""Where a kernel's local-memory loads and stores sit in its source and in its
loops, on a machine with the CUDA toolkit.

    python3 -m minilp_tpu_torch.utils.spills [--csrc DIR] [NAME ...]

Compiles `csrc/NAME.cu` (`streaming_simplex` by default; `--csrc DIR` takes
the sources of another checkout's `csrc/`) with the flags of `build.py`, but
to a cubin with `-lineinfo`, which leaves the code as it is, and
disassembles it with `nvdisasm` and its line information, inlined frames
included.  Prints one JSON line per
source: ptxas's own report (registers, stack frame, spill stores and loads
per function), and each function's `LDL` and `STL` instructions grouped by
(op, bytes, the innermost line, the outermost line of the call chain that
inlined it); then every loop of the function's control flow that holds
any of them (its header's address, its instructions, the range of the
source's lines it runs as outermost frames, its own `LDL` and `STL` bytes
and sites), so that a kernel's hot loop can be named and its local traffic
read.  These instructions are more than ptxas's spills: they also read
and write the objects that live in the stack frame (a struct whose
address a call takes), which ptxas does not count as spills.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile

from ..ops.kernels import build

#: an instruction of nvdisasm's listing: address, predicate, opcode
_INSN = re.compile(r"/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)")
_LABEL = re.compile(r"^\s*([.$][^\s:]*):")
_TARGET = re.compile(r"`\(([^)]+)\)")
#: an LDL or STL opcode and its suffixes
_LOCAL = re.compile(r"(LDL|STL)((?:\.\w+)*)$")
#: a line-information comment: its frames, innermost first
_FRAME = re.compile(r'"([^"]+)", line (\d+)')
_FUNC = re.compile(r"^\s*\.text\.(\S+):")
_WIDTH = {"": 4, ".64": 8, ".128": 16, ".U8": 1, ".S8": 1, ".U16": 2, ".S16": 2}


def _bytes(suffix: str) -> int:
    for part in suffix.split(".")[1:]:
        if "." + part in _WIDTH:
            return _WIDTH["." + part]
    return 4


def locate(src: pathlib.Path) -> dict:
    """ptxas's report and the grouped local loads and stores of one source."""
    nvcc = build._nvcc()
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        cubin = pathlib.Path(tmp) / f"{src.stem}.cubin"
        proc = subprocess.run([nvcc, *flags, "-cubin", "-lineinfo", "-o", str(cubin), str(src)],
                              capture_output=True, text=True, check=True, timeout=900)
        ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                 if any(w in ln for w in ("Function properties", "spill", "Used"))]
        listing = subprocess.run([str(pathlib.Path(nvcc).with_name("nvdisasm")), "-gi", "-c",
                                  str(cubin)], capture_output=True, text=True, check=True,
                                 timeout=300).stdout
    return dict(source=str(src), ptxas=ptxas, functions=sites(listing, src.name))


def _parse(listing: str) -> dict:
    """Per function of an nvdisasm listing, its instructions in order, each
    as (address, predicated, opcode, branch target, frames), and its labels'
    instruction indices."""
    funcs: dict = collections.OrderedDict()
    insns, labels, frames, more = None, None, [], False
    for line in listing.splitlines():
        f = _FUNC.match(line)
        if f:
            insns, labels = [], {}
            funcs[f.group(1)] = (insns, labels)
            frames, more = [], False
            continue
        if insns is None:
            continue
        if "//##" in line:  # consecutive comments extend one chain of frames
            got = [(os.path.basename(p), int(n)) for p, n in _FRAME.findall(line)]
            frames = frames + got if more else got
            more = True
            continue
        more = False
        lab = _LABEL.match(line)
        if lab:
            labels[lab.group(1)] = len(insns)
            continue
        ins = _INSN.search(line)
        if ins:
            tgt = _TARGET.search(line) if ins.group(3).startswith("BRA") else None
            insns.append((int(ins.group(1), 16), bool(ins.group(2)), ins.group(3),
                          tgt.group(1) if tgt else None, tuple(frames)))
    return funcs


def _loops(insns: list, labels: dict) -> dict:
    """The natural loops of a function's branches: header index -> the set of
    instruction indices in the loop.  A branch closes a loop where its target
    dominates it (calls fall through; the function's start and each
    subroutine's label are entries)."""
    n = len(insns)
    lead = sorted({0, *labels.values()} | {i + 1 for i, x in enumerate(insns)
                                           if x[2].startswith(("BRA", "EXIT", "RET"))})
    lead = [i for i in lead if i < n]
    spans = list(zip(lead, lead[1:] + [n]))
    block_of = [0] * n
    for b, (s, e) in enumerate(spans):
        for i in range(s, e):
            block_of[i] = b
    nb = len(spans)
    succ = [[] for _ in range(nb + 1)]  # nb: a root above every entry
    succ[nb] = [0] + [block_of[i] for lab, i in labels.items() if lab.startswith("$") and i < n]
    for b, (s, e) in enumerate(spans):
        _addr, pred, op, tgt, _fr = insns[e - 1]
        if tgt is not None and tgt in labels and labels[tgt] < n:
            succ[b].append(block_of[labels[tgt]])
        ends = op.startswith(("EXIT", "RET")) or (op == "BRA" and not pred)
        if not ends and b + 1 < nb:
            succ[b].append(b + 1)
    # dominators (Cooper, Harvey and Kennedy) over a reverse postorder
    order, seen, stack = [], {nb}, [(nb, iter(succ[nb]))]
    while stack:
        x, it = stack[-1]
        y = next(it, None)
        if y is None:
            order.append(x)
            stack.pop()
        elif y not in seen:
            seen.add(y)
            stack.append((y, iter(succ[y])))
    order.reverse()
    rank = {x: r for r, x in enumerate(order)}
    preds = collections.defaultdict(list)
    for x in order:
        for y in succ[x]:
            preds[y].append(x)
    idom = {nb: nb}
    changed = True
    while changed:
        changed = False
        for x in order[1:]:
            new = None
            for p in preds[x]:
                if p not in idom:
                    continue
                if new is None:
                    new = p
                    continue
                a, b = p, new
                while a != b:
                    while rank[a] > rank[b]:
                        a = idom[a]
                    while rank[b] > rank[a]:
                        b = idom[b]
                new = a
            if idom.get(x) != new:
                idom[x], changed = new, True

    def dominates(h, b):
        while b != nb:
            if b == h:
                return True
            b = idom[b]
        return h == nb

    loops: dict = {}
    for b in order[1:]:
        for h in succ[b]:
            if h in idom and dominates(h, b):
                body = loops.setdefault(h, {h})
                todo = [b]
                while todo:
                    x = todo.pop()
                    if x not in body:
                        body.add(x)
                        todo.extend(preds[x])
    return {lead[h]: {i for blk in body for i in range(*spans[blk])}
            for h, body in loops.items()}


def _sites(insns, idx) -> tuple:
    """LDL and STL bytes of the instructions idx, and their grouped sites."""
    groups: dict = collections.OrderedDict()
    for i in idx:
        _addr, _pred, op, _tgt, frames = insns[i]
        hit = _LOCAL.match(op)
        if hit:
            inner = "%s:%d" % frames[0] if frames else "?"
            outer = "%s:%d" % frames[-1] if frames else "?"
            key = (hit.group(1), _bytes(hit.group(2)), inner, outer)
            groups[key] = groups.get(key, 0) + 1
    total = {"LDL": 0, "STL": 0}
    out = []
    for (op, nbytes, inner, outer), count in groups.items():
        total[op] += nbytes * count
        out.append(dict(op=op, bytes=nbytes, count=count, line=inner, site=outer))
    return total["LDL"], total["STL"], out


def sites(listing: str, source: str = "") -> dict:
    """Per function of an nvdisasm listing: its LDL and STL bytes, the
    instructions grouped by (op, bytes, innermost line, outermost line), and
    every loop that holds any of them: its header's address, its size, the
    range of the lines of `source` (a file name) it runs as outermost frames,
    and its own LDL and STL bytes and sites."""
    per_func: dict = {}
    for fn, (insns, labels) in _parse(listing).items():
        ld, st, where = _sites(insns, range(len(insns)))
        if not where:
            continue
        loops = []
        for head, idx in sorted(_loops(insns, labels).items()):
            lld, lst, lwhere = _sites(insns, sorted(idx))
            if not lwhere:
                continue
            lines = [fr[-1][1] for fr in (insns[i][4] for i in idx)
                     if fr and fr[-1][0] == source]
            loops.append(dict(head="%#x" % insns[head][0], insns=len(idx),
                              lines=[min(lines), max(lines)] if lines else None,
                              LDL_bytes=lld, STL_bytes=lst, sites=lwhere))
        per_func[fn] = {"LDL_bytes": ld, "STL_bytes": st, "sites": where, "loops": loops}
    return per_func


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=["streaming_simplex"], metavar="NAME")
    ap.add_argument("--csrc", metavar="DIR", default=str(build.CSRC))
    opt = ap.parse_args(argv)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in opt.names:
        print(json.dumps(locate(pathlib.Path(opt.csrc).resolve() / f"{name}.cu")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
