"""Instruction mix of the built CUDA kernels, from their SASS.

    python3 -m unscene3d_torch.bench.sass [substring of the kernel name ...]

Builds the kernel library (`ops/_build.py`) if needed, disassembles it with
`cuobjdump -sass` and prints, for every kernel whose mangled name holds one
of the given substrings (all kernels without arguments), its instruction
count and the count of each opcode that says how a kernel feeds its
products: tensor-core MMAs (HMMA), f32 FMAs (FFMA), shared loads (LDS, of
them 128-bit LDS.128), generic and global loads (LD, LDG), ldmatrix (LDSM),
matrix transposes (MOVM), asynchronous copies (LDGSTS) and barriers (BAR),
with a digest of its instruction text that tells two builds of the same
machine code from two that differ. Needs the CUDA toolkit, not a GPU.
`ring_kernel` selects the bodies that share the ring main loop
(`gather_gemm.cuh:ring_main_loop`): kernel 1's `gather_gemm_ring_kernel`,
kernel 6's `csr_conv_ring_kernel` and kernel 9's
`win_decompose_ring_kernel<V, RingTile<NC>>` (V the variant, 0-4), one line
per tile (`RingTile`: bf16, `FmaRingTile`: f32) and Cout width. A kernel in
an anonymous namespace (kernels 6 and 9) carries a hash in its mangled name
that differs between two checkouts: compare them by the rest of the name.
"""

from __future__ import annotations

import collections
import hashlib
import os
import re
import shutil
import subprocess
import sys

from unscene3d_torch.ops import _build

OPCODES = ("HMMA", "FFMA", "LDS", "LDS.128", "LD", "LDG", "LDSM", "MOVM",
           "LDGSTS", "BAR")
# an opcode and its modifiers (LDS.U.128: "LDS", ".U.128")
_INSTR = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                    r"((?:\.[A-Z0-9_]+)*)")
# one instruction's text, between its address and its encoding comment
_TEXT = re.compile(r"/\*[0-9a-f]{4}\*/\s+([^;]*);")


def _cuobjdump() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "cuobjdump"),
                 shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found (set CUDA_HOME)")


def _functions(sass: str):
    """(mangled kernel name, its SASS block) for each kernel."""
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        yield block.split("\n", 1)[0].strip(), block


def opcode_counts(sass: str) -> dict[str, collections.Counter]:
    """Mangled kernel name -> Counter of its SASS opcodes, and of the
    128-bit shared loads under "LDS.128"."""
    out = {}
    for name, block in _functions(sass):
        found = _INSTR.findall(block)
        counts = collections.Counter(op for op, _ in found)
        counts.update(f"{op}.128" for op, mods in found
                      if op == "LDS" and ".128" in mods)
        out[name] = counts
    return out


def digests(sass: str) -> dict[str, str]:
    """Mangled kernel name -> a digest of its instruction text without
    addresses or encodings: equal digests in two builds mean the same
    machine code."""
    out = {}
    for name, block in _functions(sass):
        text = "\n".join(m.group(1).strip() for m in _TEXT.finditer(block))
        out[name] = hashlib.sha1(text.encode()).hexdigest()[:12]
    return out


def main(argv: list[str]) -> int:
    _build.load()
    lib = _build._lib_path(_build.sources())
    sass = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    digest = digests(sass)
    for name, counts in opcode_counts(sass).items():
        if argv and not any(a in name for a in argv):
            continue
        mix = " ".join(f"{op}={counts[op]}" for op in OPCODES)
        total = sum(counts.values()) - counts["LDS.128"]
        print(f"{name}: {total} instructions; {mix}; "
              f"sass {digest[name]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
