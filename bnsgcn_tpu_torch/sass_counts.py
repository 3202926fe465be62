"""What a kernel's hot loops execute, counted from its SASS on the card's
machine (nvcc and cuobjdump; `ncu` does not run there).

    python -m bnsgcn_tpu_torch.sass_counts [--sass FILE] [--out JSON]

Compiles K1 (csrc/bucket_sum.cu) for sm_90a with the port's nvcc flags
into a cubin, disassembles it with `cuobjdump -sass` (or reads a saved
disassembly, `--sass`), and for each instance of its kernel finds the
innermost loops (a branch back to an earlier address) and counts their
instructions by class. Divided by the loop's 128-bit
global loads (in K1, one gathered 16-byte vector of a row each), the counts
are per gathered vector. Prints a line per loop, and all of it as one JSON
line last.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import tempfile
from collections import Counter

from bnsgcn_tpu_torch import buildlib

K1_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                         "bucket_sum.cu")
KERNEL = "ell_rows_kernel"
# instruction classes by opcode (the part before the first '.'), with a few
# whole-opcode exceptions first
CLASSES = (
    ("load", ("LDG", "LD", "LDS", "LDSM")),
    ("store", ("STG", "ST", "STS")),
    ("shfl", ("SHFL",)),
    ("int", ("IADD3", "IADD", "IMAD", "IDP", "LEA", "VIADD", "IABS",
             "IMNMX", "VIMNMX", "ISCADD")),
    ("bits", ("PRMT", "LOP3", "LOP", "SHF", "SGXT", "BFE", "BFI", "BMSK",
              "POPC", "FLO")),
    ("cvt", ("F2F", "F2FP", "I2F", "F2I", "I2I", "I2FP", "F2IP", "FRND")),
    ("fp32", ("FADD", "FFMA", "FMUL", "FMNMX")),
    ("fp16", ("HADD2", "HFMA2", "HMUL2")),
    ("pred", ("ISETP", "FSETP", "PLOP3", "P2R", "R2P", "VOTE")),
    ("branch", ("BRA", "BSSY", "BSYNC", "EXIT", "WARPSYNC", "BAR")),
    ("move", ("MOV", "CS2R", "S2R", "SEL", "LDC")),
)
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_FN = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def classify(op: str) -> str:
    """An opcode's class; HADD2.F32 (f16 -> f32) counts as a conversion,
    uniform-datapath opcodes (U...) as 'uniform'."""
    if op.startswith("HADD2.F32"):
        return "cvt"
    head = op.split(".")[0]
    for name, ops in CLASSES:
        if head in ops:
            return name
    if head.startswith("U"):
        return "uniform"
    return "other"


def parse(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """{function name: [(address, opcode, operands), ...]} from cuobjdump
    -sass output."""
    fns: dict[str, list] = {}
    cur = None
    for line in sass.splitlines():
        m = _FN.search(line)
        if m:
            cur = fns.setdefault(m.group(1), [])
            continue
        m = _LINE.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return fns


def innermost_loops(ins) -> list[tuple[int, int]]:
    """(first, last) addresses of the loops no other loop nests in: a BRA
    to an earlier address closes a loop."""
    loops = []
    for addr, op, args in ins:
        if op.startswith("BRA"):
            m = _TARGET.search(args)
            if m and int(m.group(1), 16) <= addr:
                loops.append((int(m.group(1), 16), addr))
    return [a for a in loops if not any(
        b != a and a[0] <= b[0] and b[1] <= a[1] for b in loops)]


def loop_counts(ins, first: int, last: int) -> dict:
    body = [op for addr, op, _ in ins if first <= addr <= last]
    by_class = Counter(classify(op) for op in body)
    vec = sum(op.startswith("LDG") and ".128" in op for op in body)
    out = {"first": hex(first), "last": hex(last), "instructions": len(body),
           "vector_loads": vec, "by_class": dict(by_class),
           "by_opcode": dict(Counter(op.split(".")[0] for op in body))}
    if vec:
        out["per_vector"] = {k: round(v / vec, 3) for k, v in
                             sorted(by_class.items())}
        out["per_vector_total"] = round(len(body) / vec, 3)
    return out


_TYPES = {"a": "signed char", "h": "unsigned char", "t": "unsigned short",
          "f": "float", "i": "int"}
_ARGS = re.compile(r"I((?:[ahtfi]|Li\d+E)+)E")


def short_name(mangled: str) -> str:
    """`kernel<type, N, ...>` for a template kernel of simple arguments
    (types and ints), else the mangled name."""
    for m in re.finditer(r"\d+", mangled):
        for k in range(len(m.group())):       # a length may follow digits
            end = m.end() + int(m.group()[k:])
            name = mangled[m.end():end]
            a = _ARGS.match(mangled, end)
            if a and name.isidentifier():
                args = re.findall(r"Li(\d+)E|([ahtfi])", a.group(1))
                return name + "<" + ", ".join(
                    n if n else _TYPES[t] for n, t in args) + ">"
    return mangled


def disassemble(source: str) -> str:
    nvcc = buildlib.find_nvcc()
    flags = [f for f in buildlib.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as d:
        cubin = os.path.join(d, "k.cubin")
        subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, source],
                       check=True, capture_output=True, text=True)
        tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        return subprocess.run([tool, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass", default="",
                    help="read this saved disassembly instead of compiling")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)
    if args.sass:
        with open(args.sass) as f:
            sass = f.read()
    else:
        sass = disassemble(K1_SOURCE)
    fns = {k: v for k, v in parse(sass).items() if KERNEL in k}
    names = {k: short_name(k) for k in fns}
    report = []
    for raw in sorted(fns):
        ins = fns[raw]
        loops = [loop_counts(ins, a, b) for a, b in innermost_loops(ins)]
        loops = [x for x in loops if x["vector_loads"]]
        report.append({"kernel": names[raw], "instructions": len(ins),
                       "loops": loops})
        for x in loops:
            per = ", ".join(f"{k} {v}" for k, v in x["per_vector"].items())
            print(f"{names[raw]} loop {x['first']}..{x['last']}: "
                  f"{x['instructions']} instructions, {x['vector_loads']} "
                  f"vector loads; per vector {x['per_vector_total']}: {per}")
    line = json.dumps({"source": os.path.relpath(K1_SOURCE),
                       "kernels": report})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
