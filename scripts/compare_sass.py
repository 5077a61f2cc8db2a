#!/usr/bin/env python3
"""Says whether the port's CUDA kernels compile to the same machine code in
two trees: builds the kernel library of this tree and of another (an
unpacked checkout of another commit, e.g. ``git archive`` of the parent into
a directory that ``.gitignore`` lists), each in a process of its own, and
compares the SASS (``cuobjdump -sass``) of every kernel the two libraries
hold, line by line with runs of blanks taken as one (``cuobjdump`` pads its
columns to the widest instruction of a listing). Run from the root of the
repository, on a machine with the CUDA toolkit:

    python3 scripts/compare_sass.py --parent DIR [--rename OLD=NEW ...]

A kernel whose template gained or lost a parameter has another name in this
tree; ``--rename OLD=NEW`` (repeatable) replaces OLD by NEW in the other
tree's kernel names, as ``cu++filt`` prints them (e.g.
``linear_residual_ln_kernel<(int)1, (int)1, `` by
``linear_residual_ln_kernel<(int)1, ``), before the compare. Prints how
many kernels both hold, how many are identical, the ones that differ (with
the first lines where they do), and the kernels only one tree holds; exits
1 when a kernel both hold differs.
"""

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def sass(lib: str) -> dict:
    """{kernel name: its SASS} of a built library; names as ``cu++filt``
    prints them, each line with its runs of blanks taken as one."""
    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
        elif line.startswith("Fatbin"):  # the next object's header: the last kernel ended
            name = None
        elif name is not None:
            kernels[name].append(" ".join(line.split()))
    names = subprocess.run(["/usr/local/cuda/bin/cu++filt"], input="\n".join(kernels),
                           capture_output=True, text=True, check=True).stdout.splitlines()
    return {n.replace("(anonymous namespace)::", ""): "\n".join(body).rstrip()
            for n, body in zip(names, kernels.values())}


def compare(parent_lib: str, change_lib: str, renames=()) -> list:
    """Prints the comparison of the two libraries' SASS (``renames``: pairs
    of name pieces, the parent's and this tree's); returns the names of the
    kernels both hold whose SASS differs."""
    parent, change = sass(parent_lib), sass(change_lib)
    for old, new in renames:
        parent = {k.replace(old, new): v for k, v in parent.items()}
    common = sorted(set(parent) & set(change))
    differ = [k for k in common if parent[k] != change[k]]
    print(f"SASS: {len(common)} kernels in both libraries, {len(common) - len(differ)} "
          f"identical; differing: {differ or 'none'}")
    print(f"only the parent's: {sorted(set(parent) - set(change)) or 'none'}")
    print(f"only this tree's: {sorted(set(change) - set(parent)) or 'none'}")
    for k in differ:  # where they differ: from the first line that does
        a, b = parent[k].splitlines(), change[k].splitlines()
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        print(f"  {k[:80]}: {len(a)} / {len(b)} lines, the first {i} the same; then the "
              f"parent's {' | '.join(a[i:i + 6])} ; this tree's {' | '.join(b[i:i + 6])}")
    return differ

BUILD = "from chadavit_tpu_torch.ops import _build; print(_build.build())"


def build(trees):
    """The library path of each tree, built at once in processes of their own."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for tree in trees]
    libs = []
    for tree, proc in zip(trees, procs):
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"build of {tree} failed:\n{err}")
        libs.append(out.strip().splitlines()[-1])
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--rename", action="append", default=[])
    args = ap.parse_args()
    renames = [r.split("=", 1) for r in args.rename]
    parent_lib, change_lib = build([args.parent.resolve(), ROOT])
    differ = compare(parent_lib, change_lib, renames)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
