"""Compare the machine code of two versions of one CUDA source, kernel by kernel.

    python -m diffusionkit_tpu_torch.tools.sass_diff OLD.cu NEW.cu

Each source is compiled to a cubin for sm_90a with the flags of
``ops/kernels.py`` (``nvcc -cubin``) and disassembled by ``cuobjdump
-sass``. For every kernel either cubin holds, it prints IDENTICAL, DIFFERS
or which side has it, with the instruction counts (all of the kernel's, and
those of its main path: see ``main_path``): addresses, encodings and the
translation unit's hash in the mangled name are stripped first, so a
kernel whose source did not change compares IDENTICAL. A refactor that must
leave a kernel's code alone (one template body shared by new modes) is
checked this way. Needs the CUDA toolkit (the machine with the card).
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..ops import kernels

_FUNCTION = re.compile(r"\s*Function : (\S+)")
_TU_HASH = re.compile(r"_GLOBAL__N__[0-9a-f]+_")
_ADDRESS = re.compile(r"/\*[0-9a-f]{4,}\*/")
_ENCODING = re.compile(r"/\* 0x[0-9a-f]+ \*/")
_LABEL = re.compile(r"^\.L_x_\d+:$")
_COND_BRANCH = re.compile(
    r"^@!?U?P\w+\s+BRA\S*\s+(?:!?U?P\w+,\s*)?`?\(?(\.L_x_\d+|0x[0-9a-f]+)")


def sass_functions(text: str) -> Dict[str, List[str]]:
    """cuobjdump -sass output -> {kernel name: its instructions}, the
    translation unit's hash cut from the name, addresses and encodings from
    each line, blank lines dropped."""
    funcs: Dict[str, List[str]] = {}
    name = None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            name = _TU_HASH.sub("_GLOBAL__N__", m.group(1))
            funcs[name] = []
            continue
        if name is None:
            continue
        line = _ENCODING.sub("", _ADDRESS.sub("", line)).strip()
        if line:
            funcs[name].append(line)
    return funcs


def listings(text: str) -> Dict[str, List[Tuple[Optional[int], str]]]:
    """cuobjdump -sass output -> {kernel name: [(address or None for a
    label, instruction)]}, names as ``sass_functions`` gives them."""
    funcs: Dict[str, List[Tuple[Optional[int], str]]] = {}
    name = None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            name = _TU_HASH.sub("_GLOBAL__N__", m.group(1))
            funcs[name] = []
            continue
        if name is None:
            continue
        addr = _ADDRESS.search(line)
        line = _ENCODING.sub("", _ADDRESS.sub("", line)).strip()
        if line:
            funcs[name].append((int(addr.group(0)[2:-2], 16) if addr else None, line))
    return funcs


def main_path(listing: List[Tuple[Optional[int], str]]) -> int:
    """Instructions a thread issues on a kernel's common path: from the
    entry to the first unpredicated EXIT, labels and NOPs not counted, and
    without a division's or reciprocal's call of its slow path (a CALL in
    at most 4 instructions that a forward conditional branch skips). The
    slow paths themselves lie past the EXIT. Every other instruction
    before the EXIT counts, as a row kernel's active thread runs them."""
    where = {}  # branch target (address or label) -> index
    for i, (addr, line) in enumerate(listing):
        if addr is not None:
            where[addr] = i
        elif _LABEL.match(line):
            where[line[:-1]] = i
    end = next((i for i, (_, line) in enumerate(listing) if line.startswith("EXIT")),
               len(listing) - 1)
    count, i = 0, 0
    while i <= end:
        addr, line = listing[i]
        i += 1
        if addr is None or line.startswith("NOP"):
            continue
        count += 1
        m = _COND_BRANCH.match(line)
        if not m:
            continue
        label = m.group(1)
        target = where.get(int(label, 16) if label.startswith("0x") else label)
        if target is None or not i <= target <= end:
            continue
        skipped = [line for _, line in listing[i:target]]
        if len(skipped) <= 4 and any(x.startswith("CALL") for x in skipped):
            i = target
    return count


def compare(old: Dict[str, List[str]],
            new: Dict[str, List[str]]) -> List[Tuple[str, str, int, int]]:
    """(status, kernel, old count, new count) for every kernel of either
    side, by name: IDENTICAL, DIFFERS, "only old" or "only new"."""
    rows = []
    for name in sorted(set(old) | set(new)):
        a, b = old.get(name), new.get(name)
        if a is None or b is None:
            status = "only new" if a is None else "only old"
        else:
            status = "IDENTICAL" if a == b else "DIFFERS"
        rows.append((status, name, len(a or []), len(b or [])))
    return rows


def disassemble(source: Path, cubin: Path) -> str:
    """The SASS of ``source`` compiled for sm_90a with ops/kernels.py's flags."""
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-cubin", "-o", str(cubin), str(source)],
                   check=True, capture_output=True)
    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout


def main(argv: Optional[List[str]] = None) -> None:
    old_src, new_src = (Path(a) for a in (sys.argv[1:] if argv is None else argv))
    with tempfile.TemporaryDirectory() as tmp:
        texts = [disassemble(src, Path(tmp) / f"{i}.cubin")
                 for i, src in enumerate((old_src, new_src))]
    old, new = (sass_functions(t) for t in texts)
    paths = [listings(t) for t in texts]
    for status, name, n_old, n_new in compare(old, new):
        p_old, p_new = (main_path(side.get(name, [])) for side in paths)
        print(f"{status}: {name} ({n_old} / {n_new} instructions, main path {p_old} / {p_new})",
              flush=True)


if __name__ == "__main__":
    main()
