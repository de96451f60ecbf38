"""Machine code of the kernels against an earlier tree's: each CUDA source
that both ``csrc/`` directories hold is compiled by nvcc with the build's
flags into a cubin, ``cuobjdump -sass`` prints its SASS, and every kernel
of one name in both is compared instruction by instruction; ptxas's
registers and spills stand beside it.

    python -m mimo_tpu_torch.tools.compare_sass --against OLD_CSRC \
        [flash_attention.cu ...]

OLD_CSRC is a copy of an earlier ``mimo_tpu_torch/csrc`` (for example from
``git archive`` of the parent commit into an ignored directory). Prints a
line a kernel (where it differs, also how many lines differ once register
numbers are set aside) and one JSON line; exits 1 if a kernel's SASS
differs.
Needs nvcc and cuobjdump (the CUDA toolkit), no card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

from mimo_tpu_torch.ops import _build


def _tool(name: str) -> str:
    return str(Path(_build.find_nvcc()).with_name(name))


def kernel_name(mangled: str) -> str:
    """The mangled name without the anonymous namespace's, which nvcc
    derives from the source's path and contents (``<n>_GLOBAL__N__...``,
    n characters)."""
    m = re.search(r"(\d+)_GLOBAL__N_", mangled)
    if not m:
        return mangled
    return (mangled[:m.start()] + "_GLOBAL__N_"
            + mangled[m.start(1) + len(m[1]) + int(m[1]):])


def compile_sass(src: Path, out: Path) -> Tuple[Dict[str, str],
                                               Dict[str, str]]:
    """({kernel: SASS}, {kernel: ptxas registers and spills}) of one
    source, built with the library's flags."""
    cubin = out / (src.stem + ".cubin")
    res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-cubin",
                          "-o", str(cubin), str(src)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src} failed:\n{res.stdout}{res.stderr}")
    usage, name, spills = {}, None, ""
    for line in (res.stdout + res.stderr).splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line.split("'")[1])
        elif "spill stores" in line and name:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            usage[name] = (line.split("Used")[1].split(",")[0].strip()
                           + "; " + spills)
            name = None
    dump = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    sass, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            sass[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            sass[name].append(line.strip())
    return {k: "\n".join(v) for k, v in sass.items()}, usage


def _unnamed(line: str) -> str:
    """An instruction line without its address, encoding and register
    numbers (R7, UR12, P0, UP1 become R, UR, P, UP)."""
    instr = line.split("*/", 1)[1].split("/*", 1)[0]
    return re.sub(r"\b(U?R|U?P)\d+\b", r"\1", instr).strip()


def _differ(a, b) -> int:
    """Lines of two SASS listings that differ, position by position."""
    a, b = list(a), list(b)
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True, type=Path,
                    help="an earlier csrc/ directory")
    ap.add_argument("sources", nargs="*",
                    help="sources to compare (default: every .cu in both)")
    args = ap.parse_args(argv)
    names = args.sources or sorted(
        p.name for p in _build.CSRC.glob("*.cu")
        if (args.against / p.name).exists())
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor() as pool:
        jobs = {}
        for tree, root in (("old", args.against), ("new", _build.CSRC)):
            for n in names:
                out = Path(tmp) / tree
                out.mkdir(exist_ok=True)
                jobs[tree, n] = pool.submit(compile_sass, root / n, out)
        built = {key: job.result() for key, job in jobs.items()}
    report, differ = [], 0
    for n in names:
        (old, old_use), (new, new_use) = built["old", n], built["new", n]
        for kernel in sorted(set(old) & set(new)):
            a, b = old[kernel].splitlines(), new[kernel].splitlines()
            diff = _differ(a, b)
            renamed = _differ(*(map(_unnamed, x) for x in (a, b)))
            differ += diff > 0
            report.append(dict(source=n, kernel=kernel, instructions=len(b),
                               identical=diff == 0, lines_differ=diff,
                               differ_but_register_names=renamed,
                               old=old_use.get(kernel),
                               new=new_use.get(kernel)))
            what = ("identical" if diff == 0 else
                    f"{diff} lines differ, {renamed} but for register names")
            print(f"{n} {kernel}: {len(a)} / {len(b)} instructions, {what}; "
                  f"old {old_use.get(kernel)} | new {new_use.get(kernel)}",
                  flush=True)
        for kernel in sorted(set(old) ^ set(new)):
            print(f"{n} {kernel}: only in the "
                  f"{'old' if kernel in old else 'new'} tree")
    print(json.dumps({"sass": report, "kernels_differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
