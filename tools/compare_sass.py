"""Compare the SASS of one kernel function between two checkouts.

    python3 tools/compare_sass.py OLD_TREE NEW_TREE [KERNEL [FUNCTION...]]

Builds ``KERNEL``'s library (default ``fused_interval``) in each tree with
that tree's own ``repro_torch.kernels.build`` (into the tree's
``build/``), dumps it with ``cuobjdump -sass`` and compares the
instructions of the functions whose mangled names hold each FUNCTION
substring (default: the scalar fused-interval kernel, ``fused_interval_
kernel`` in the old tree and its ``<0>`` instantiation, ``fused_interval_
kernelILi0E``, in the new one).  Addresses, the function's name and
relocation names are dropped before the comparison.  Needs the CUDA
toolkit (nvcc, cuobjdump); no card.  Prints one JSON line and exits 1
when the instructions differ.
"""
import json
import re
import subprocess
import sys
from pathlib import Path


def build_library(tree: Path, kernel: str) -> Path:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; "
            "print(build.build([sys.argv[2]])[sys.argv[2]])")
    out = subprocess.run([sys.executable, "-c", code, str(tree / "src"),
                          kernel], capture_output=True, text=True,
                         check=True, timeout=900)
    return Path(out.stdout.strip().splitlines()[-1])


def functions(lib: Path) -> dict:
    """{mangled name: [instruction, ...]} of a library's SASS."""
    nvcc = subprocess.run(["which", "nvcc"], capture_output=True,
                          text=True).stdout.strip() or "/usr/local/cuda/bin/nvcc"
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if name and m:
            funcs[name].append(re.sub(r"\s+", " ", m.group(1)).strip())
    return funcs


def pick(funcs: dict, key: str) -> tuple:
    hits = [n for n in funcs if key in n]
    if len(hits) != 1:
        raise SystemExit(f"compare_sass: {len(hits)} functions match "
                         f"{key!r}: {hits}")
    return hits[0], funcs[hits[0]]


def main():
    if len(sys.argv) < 3:
        raise SystemExit(__doc__)
    old, new = (Path(a).resolve() for a in sys.argv[1:3])
    kernel = sys.argv[3] if len(sys.argv) > 3 else "fused_interval"
    keys = sys.argv[4:6] if len(sys.argv) > 5 else (
        "fused_interval_kernel", "fused_interval_kernelILi0E")
    (old_name, a), (new_name, b) = (
        pick(functions(build_library(tree, kernel)), key)
        for tree, key in zip((old, new), keys))
    differ = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    same = len(a) == len(b) and not differ
    print(json.dumps({"kernel": kernel, "old": old_name, "new": new_name,
                      "old_instructions": len(a),
                      "new_instructions": len(b), "identical": same,
                      "first_differences": [(i, a[i], b[i])
                                            for i in differ[:5]]}))
    raise SystemExit(0 if same else 1)


if __name__ == "__main__":
    main()
