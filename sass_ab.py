#!/usr/bin/env python3
"""Compare the machine code of the streaming chunk kernels' instances in two checkouts.

Run from the root of a checkout, on a host with the CUDA toolkit, with the
other checkout (for example the parent commit, unpacked with ``git archive``
into a directory that ``.gitignore`` lists)::

    python3 sass_ab.py OTHER_ROOT

Compiles ``csrc/stream_chunk.cu`` and ``csrc/stream_chunk_routed.cu`` of
both checkouts for ``sm_90a`` with the port's flags
(``kernels/_lib.py``: ``NVCC_FLAGS`` and ``EXACT_FLAGS``), disassembles each
cubin with ``cuobjdump -sass`` and pairs every kernel of OTHER_ROOT with
this checkout's kernel of the same template arguments, the pooled flag
``PL = false`` appended when this checkout has it. Two kernels are the same
when their instructions are, addresses and encodings aside; when they are
not, it says whether their opcodes still are (the same instructions on other
registers or branch targets). Prints a line a kernel (same or differs, with
each side's registers from ``ptxas -v`` and the first differing
instructions), then the kernels this checkout adds, and as its last line
one JSON object ``{"same": n, "same_opcodes": [...], "differ": [...],
"missing": [...], "added": [...]}``; ``differ`` lists those whose opcodes
differ too. Exits 1 when a kernel differs or is missing. It needs no card.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCES = ("stream_chunk.cu", "stream_chunk_routed.cu")


def _flags(root: Path) -> list:
    """The build flags of ``root``'s ``kernels/_lib.py``, read from its text
    (the module is not imported: the two checkouts share a package name)."""
    text = (root / "src" / "repro_torch" / "kernels" / "_lib.py").read_text()
    flags = []
    for name in ("NVCC_FLAGS", "EXACT_FLAGS"):
        body = re.search(rf"^{name} = \((.*?)\)\n", text, re.S | re.M).group(1)
        flags += re.findall(r'"([^"]*)"', body)
    return flags


def _nvcc() -> str:
    for cand in ("nvcc", "/usr/local/cuda/bin/nvcc"):
        try:
            subprocess.run([cand, "--version"], capture_output=True, check=True)
            return cand
        except (OSError, subprocess.CalledProcessError):
            pass
    raise RuntimeError("nvcc not found")


def _kernels(root: Path, source: str, tmp: Path) -> dict:
    """Mangled name -> (instructions, registers) of every kernel of
    ``root``'s ``source``, compiled to a cubin."""
    nvcc = _nvcc()
    cubin = tmp / f"{root.name}-{source}.cubin"
    flags = [f for f in _flags(root) if f not in ("-Xcompiler", "-fPIC")]
    build = subprocess.run([nvcc, *flags, "-cubin", str(root / "src" / "repro_torch" / "csrc" /
                                                         source), "-o", str(cubin)],
                           capture_output=True, text=True)
    if build.returncode:
        raise RuntimeError(f"{root}: {source} did not build:\n{build.stdout}{build.stderr}")
    regs, entry = {}, None
    for line in (build.stdout + build.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m.group(1))
    cuobjdump = str(Path(nvcc).parent / "cuobjdump") if "/" in nvcc else "cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    out, name, body = {}, None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\w+)", line)
        if m:
            if name:
                out[name] = (body, regs.get(name))
            name, body = m.group(1), []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if name and m:
            body.append(m.group(1))
    if name:
        out[name] = (body, regs.get(name))
    return out


def _opcodes(body: list) -> list:
    """The instructions' opcodes, predicates and operands dropped."""
    return [re.sub(r"^@!?\w+\s+", "", ins).split()[0] for ins in body]


def _scalar_name(name: str) -> str:
    """A kernel's name and template arguments, as the checkout before the
    pooled flag had them: the anonymous namespace's tag (a hash that differs
    between checkouts) blanked, the parameter types dropped (the pooled
    checkout spells its argument struct as a type of PL), and the last
    template argument ``Lb0E`` (``PL = false``) taken out."""
    name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", name)
    m = re.match(r"(.*?I(?:L[a-z]+\d+E)+E)", name)
    return (m.group(1) if m else name).replace("ELb0EE", "EE", 1)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    same, same_ops, differ, missing, added = 0, [], [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        for source in SOURCES:
            old = _kernels(other, source, Path(tmp))
            new = _kernels(HERE, source, Path(tmp))
            by_old = {_scalar_name(k): k for k in new}
            for name, (body, regs) in sorted(old.items()):
                mine = by_old.get(_scalar_name(name))
                if mine is None:
                    missing.append(name)
                    print(f"{source}: {name}: missing here")
                    continue
                nbody, nregs = new[mine]
                ok, ops = body == nbody, _opcodes(body) == _opcodes(nbody)
                same += ok
                if not ok:
                    (same_ops if ops else differ).append(name)
                diff = sum(a != b for a, b in zip(body, nbody)) + abs(len(body) - len(nbody))
                verdict = "same" if ok else "DIFFERS, same opcodes" if ops else "DIFFERS"
                print(f"{source}: {name}: {verdict} ({len(body)} "
                      f"instructions there, {len(nbody)} here, {diff} differ; registers "
                      f"{regs} there, {nregs} here)")
                firsts = [(i, a, b) for i, (a, b) in enumerate(zip(body, nbody)) if a != b][:4]
                for i, a, b in firsts:
                    print(f"    #{i}: {a!r} there, {b!r} here")
            for name in sorted(set(new) - {by_old.get(_scalar_name(k)) for k in old}):
                added.append(name)
                print(f"{source}: {name}: added here ({len(new[name][0])} instructions, "
                      f"registers {new[name][1]})")
    print(json.dumps({"same": same, "same_opcodes": same_ops, "differ": differ,
                      "missing": missing, "added": added}))
    return 1 if same_ops or differ or missing else 0


if __name__ == "__main__":
    sys.exit(main())
