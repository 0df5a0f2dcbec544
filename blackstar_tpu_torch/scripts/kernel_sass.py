"""What ptxas and the SASS say of the march kernels B1 (``ops/csrc/march.cu``)
and B2 (``ops/csrc/march_adjoint.cu``) as they are built for the card.

Run where the CUDA toolkit is (``nvcc``, ``cuobjdump``)::

    python -m blackstar_tpu_torch.scripts.kernel_sass

Per kernel instance it prints ptxas's registers, stack frame and spills
(``-Xptxas -v``), and the loops of its SASS: a loop is a backward branch
and the instructions from its target to it, given as (instructions,
floating-point ALU instructions, MUFU instructions), largest first, and
for the largest loop its MUFU instructions by kind (``RSQ``, ``RCP``, ...),
its ``FCHK`` (the range check of an IEEE float divide) and its calls (the
slow paths of divide, square root and sine). A span counts code a step may
skip (the rare disk hit, those slow paths), so it bounds from above what
one step issues.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
from typing import NamedTuple

from blackstar_tpu_torch.ops import _build

_KERNEL = re.compile(r"(march_adjoint_kernel|march_kernel|star_lookup_kernel|star_vjp_kernel)"
                     r"I((?:f|d|Lb[01]E)+)E")
_TEMPLATE_ARGS = {"f": "float", "d": "double", "Lb0E": "false", "Lb1E": "true"}
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FP = re.compile(r"^(@!?U?P\w+\s+)?(FADD|FMUL|FFMA|FSETP|FMNMX|FSEL|DADD|DMUL|DFMA|DSETP)\b")


def short_name(mangled: str) -> str:
    """``march_kernel<float, true>`` for B1's, B2's, B3's or B4's mangled name."""
    m = _KERNEL.search(mangled)
    if m is None:
        return mangled
    args = re.findall(r"f|d|Lb[01]E", m.group(2))
    return f"{m.group(1)}<{', '.join(_TEMPLATE_ARGS[a] for a in args)}>"


def compile_cubin(source: str, flags) -> tuple:
    """Compile ``source`` with ``flags`` to a cubin under ``-Xptxas -v``, as
    its library is compiled. Returns ptxas's report and the cubin's path."""
    out_dir = os.path.join(_build.BUILD_DIR, "cubin")
    os.makedirs(out_dir, exist_ok=True)
    cubin = os.path.splitext(os.path.join(
        out_dir, os.path.basename(_build.library_path(source, flags))))[0] + ".cubin"
    cmd = [_build._nvcc(), "-arch=sm_90a", "-O3", "-std=c++17", "-cubin", *flags,
           "-Xptxas", "-v", "-o", cubin, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr, cubin


def resources(report: str) -> dict:
    """Per kernel instance in a ptxas report: its registers, stack frame and
    spills, as one line."""
    frames, out = {}, {}
    name = None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line)
        if m:
            name = m.group(1)
        elif "stack frame" in line and name:
            frames[name] = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used \d+ registers", line).group(0)
            out[short_name(name)] = f"{regs}, {frames.get(name, 'no stack report')}"
    return out


class Loop(NamedTuple):
    """A SASS loop: its span in instructions, its FP ALU and MUFU
    instructions, its MUFU instructions by kind, its FCHKs and calls."""

    instructions: int
    fp: int
    mufu: int
    mufu_ops: dict
    fchk: int
    calls: int


def parse_sass(text: str) -> dict:
    """Per kernel instance in ``cuobjdump -sass`` output: its instruction
    count and its loops (:class:`Loop`), largest first."""
    result = {}
    for part in text.split("Function : ")[1:]:
        code = [(int(a, 16), ins) for a, ins in _SASS_LINE.findall(part)]
        loops = []
        for addr, ins in code:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
            if m and int(m.group(1), 16) < addr:
                body = [x for a, x in code if int(m.group(1), 16) <= a <= addr]
                ops = collections.Counter(
                    m.group(1) for m in (re.search(r"\bMUFU\.(\w+)", x) for x in body) if m)
                loops.append(Loop(len(body), sum(bool(_FP.match(x)) for x in body),
                                  sum(ops.values()), dict(sorted(ops.items())),
                                  sum(bool(re.search(r"\bFCHK\b", x)) for x in body),
                                  sum(bool(re.search(r"\bCALL\b", x)) for x in body)))
        loops.sort(key=lambda lp: lp.instructions, reverse=True)
        result[short_name(part.split()[0])] = (len(code), loops)
    return result


def sass_loops(cubin: str) -> dict:
    """:func:`parse_sass` of ``cubin``'s SASS (``cuobjdump -sass``)."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return parse_sass(subprocess.run([tool, "-sass", cubin], capture_output=True, text=True,
                                     check=True).stdout)


def describe(cubin: str, report: str) -> list:
    """One line per kernel instance: ptxas's resources, the instruction
    count, the largest loops as (instructions, FP ALU, MUFU) and the
    largest loop's MUFU kinds, FCHKs and calls."""
    res = resources(report)
    lines = []
    for name, (n_ins, loops) in sass_loops(cubin).items():
        top = loops[0] if loops else None
        lines.append(
            f"{name}: {res.get(name, 'no ptxas report')}; {n_ins} SASS instructions; loops "
            f"(instructions, FP ALU, MUFU), largest first: "
            f"{[(lp.instructions, lp.fp, lp.mufu) for lp in loops[:5]]}"
            + (f"; largest loop: MUFU {top.mufu_ops}, FCHK {top.fchk}, calls {top.calls}"
               if top else ""))
    return lines


def main() -> None:
    from blackstar_tpu_torch.ops import march_adjoint_cuda, march_cuda

    for mod in (march_cuda, march_adjoint_cuda):
        report, cubin = compile_cubin(mod.SOURCE, mod.FLAGS)
        for line in describe(cubin, report):
            print(line)


if __name__ == "__main__":
    main()
