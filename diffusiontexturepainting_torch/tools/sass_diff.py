"""Whether the kernels of one csrc source compile to the same machine code
in two checkouts: each checkout's csrc/<source>.cu is built with the
package's nvcc flags, cuobjdump lists each kernel's SASS, and every kernel
of the other checkout is matched, instruction for instruction (addresses
and encodings left out), to a kernel of this one.

    python -m diffusiontexturepainting_torch.tools.sass_diff \\
        --source gn_conv_sm90 --other <another checkout's root>

Prints, for each kernel of the other checkout, the (demangled) name of the
kernel of this checkout with the same instructions, or that none has them
and its differences from the nearest kernel here (--show lines of a
unified diff); then the kernels of this checkout that match none (new
code); then one JSON line. Exits nonzero where a kernel of the other
checkout has no match. Needs nvcc and cuobjdump (the CUDA toolkit), not a
card.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from diffusiontexturepainting_torch import _cuda

_COMMENT = re.compile(r"/\*.*?\*/")


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    return os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", name)


def build(csrc: Path, source: str, out_dir: Path) -> Path:
    """csrc/<source>.cu of one checkout into a library in out_dir."""
    out = out_dir / f"lib{source}.so"
    cmd = [_tool("nvcc"), *_cuda.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
           str(csrc / f"{source}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {csrc / source}.cu:\n"
                           f"{proc.stderr}")
    return out


def kernels(lib: Path) -> dict[str, tuple[str, ...]]:
    """{mangled name: its SASS instructions, addresses and encodings
    dropped}."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out: dict[str, list[str]] = {}
    name = None
    for line in text.splitlines():
        head = line.strip()
        if head.startswith("Function : "):
            name = head[len("Function : "):]
            out[name] = []
            continue
        if name is None or head.startswith("."):
            continue
        ins = _COMMENT.sub("", line).strip()
        if ins:
            out[name].append(ins)
    return {k: tuple(v) for k, v in out.items()}


def demangle(names) -> dict[str, str]:
    names = list(names)
    proc = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                          capture_output=True, text=True)
    lines = proc.stdout.splitlines() if proc.returncode == 0 else names
    return dict(zip(names, lines if len(lines) == len(names) else names))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", required=True)
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--show", type=int, default=40,
                    help="diff lines shown for each kernel that differs")
    args = ap.parse_args(argv)
    other_csrc = Path(args.other) / "diffusiontexturepainting_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        mine = kernels(build(_cuda.CSRC, args.source, Path(tmp) / "."))
        theirs_dir = Path(tmp) / "other"
        theirs_dir.mkdir()
        theirs = kernels(build(other_csrc, args.source, theirs_dir))
    names = demangle(list(mine) + list(theirs))
    by_code: dict[tuple[str, ...], list[str]] = {}
    for name, code in mine.items():
        by_code.setdefault(code, []).append(name)
    matched, missing, used = [], [], set()
    for name, code in theirs.items():
        hits = by_code.get(code, [])
        if hits:
            used.update(hits)
            matched.append(name)
            print(f"same: {names[name]} -> {names[hits[0]]} "
                  f"({len(code)} instructions)", flush=True)
        else:
            missing.append(name)
            near = max(mine, key=lambda n: difflib.SequenceMatcher(
                None, code, mine[n], autojunk=False).quick_ratio())
            print(f"DIFFERS: {names[name]} ({len(code)} instructions) has no "
                  f"kernel with its instructions here; nearest "
                  f"{names[near]} ({len(mine[near])}):", flush=True)
            diff = difflib.unified_diff(code, mine[near], lineterm="", n=1)
            for line in list(diff)[2:2 + args.show]:
                print("    " + line, flush=True)
    new = [n for n in mine if n not in used]
    for name in new:
        print(f"new: {names[name]} ({len(mine[name])} instructions)",
              flush=True)
    print(json.dumps({"source": args.source, "other": args.other,
                      "other_kernels": len(theirs), "kernels": len(mine),
                      "same": len(matched), "differs": len(missing),
                      "new": len(new)}), flush=True)
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main())
