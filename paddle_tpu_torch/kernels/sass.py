"""What the CUDA compiler made of the port's kernels: instruction counts
and instruction-for-instruction comparisons of two builds, read with
``cuobjdump -sass`` (needs the CUDA toolkit; nothing runs at import).

    python -m paddle_tpu_torch.kernels.sass compare OLD.so NEW.so \
        fwd_wgmma_kernel fwd_f32_kernel dq_f32_kernel dkv_f32_kernel

prints, for every instantiation of the named kernels found in both
libraries, its instruction count and whether the two builds hold the same
instructions in the same order (function names aside: the anonymous
namespace's name carries a hash of the source file), and exits 1 if any
differs or is missing from one build.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from typing import Dict, Iterable, List

__all__ = ["functions", "instruction_counts", "compare"]


def _kernel_name(mangled: str) -> str:
    """``<identifier><template args>`` of a mangled kernel name whose
    identifier ends in ``_kernel``: in a nested name (``_ZN`` then
    length-prefixed parts, the anonymous namespace's first:
    ``_ZN51_GLOBAL__N__..._cu_2c13897916fwd_wgmma_kernelI...``) the first
    part that is such an identifier, or the name itself."""
    if mangled.startswith("_ZN"):
        pos = 3
        while True:
            m = re.match(r"\d+", mangled[pos:])
            if m is None:
                break
            start = pos + m.end()
            ident = mangled[start:start + int(m.group())]
            if ident.endswith("_kernel"):
                return mangled[start:]
            pos = start + len(ident)
    return mangled


def _cuobjdump() -> str:
    from ._build import _nvcc
    return os.path.join(os.path.dirname(_nvcc()), "cuobjdump")


def functions(lib: str) -> Dict[str, List[str]]:
    """Each kernel of a built library, keyed by its name without the
    anonymous namespace (``dq_wgmma_kernel<bf16, 128, false>`` in mangled
    form: ``dq_wgmma_kernelI13__nv_bfloat16Li128ELb0EEEvNS_9BwdParams``
    ``E``), with its SASS instructions (address and encoding stripped)."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs: Dict[str, List[str]] = {}
    cur = None
    for line in out.splitlines():
        if "Function :" in line:
            cur = _kernel_name(line.split("Function :", 1)[1].strip())
            funcs[cur] = []
        elif cur is not None and line.strip().startswith("/*") and ";" in line:
            # "/*0040*/   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;  /* 0x... */"
            funcs[cur].append(line.split("*/", 1)[1].split(";", 1)[0].strip())
    return funcs


def instruction_counts(lib: str, kernel: str,
                       opcodes: Iterable[str]) -> Dict[str, Dict[str, int]]:
    """For each instantiation of ``kernel`` in ``lib``: how many of its
    instructions start with each opcode (``HGMMA`` counts
    ``HGMMA.64x128x16.F32.BF16`` and the like), and ``total``."""
    counts = {}
    for name, insts in functions(lib).items():
        if not name.startswith(kernel):
            continue
        c = {op: sum(1 for i in insts
                     if re.match(rf"(@!?U?P\w+\s+)?{op}\b", i))
             for op in opcodes}
        c["total"] = len(insts)
        counts[name] = c
    return counts


def compare(old: str, new: str, kernels: Iterable[str]) -> Dict[str, dict]:
    """For every instantiation of ``kernels`` in either library: its
    instruction count in each and whether the two are the same
    instructions in the same order."""
    a, b = functions(old), functions(new)
    report = {}
    for name in sorted(set(a) | set(b)):
        if not any(name.startswith(k) for k in kernels):
            continue
        report[name] = {"old": len(a[name]) if name in a else None,
                        "new": len(b[name]) if name in b else None,
                        "same": name in a and name in b and a[name] == b[name]}
    return report


def main(argv: List[str]) -> int:
    if len(argv) < 4 or argv[0] != "compare":
        print(__doc__)
        return 2
    old, new, kernels = argv[1], argv[2], argv[3:]
    report = compare(old, new, kernels)
    for name, r in report.items():
        print(f"{'same' if r['same'] else 'DIFFERENT'}  {r['old']} / "
              f"{r['new']} instructions  {name}")
    same = sum(r["same"] for r in report.values())
    print(f"{same} of {len(report)} instantiations of {list(kernels)} are "
          f"the same instructions in both builds")
    return 0 if report and same == len(report) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
