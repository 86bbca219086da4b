"""Show that two sources of the batched RK library compile to the same
machine code: each is built with the library's own flags and every
kernel's SASS (cuobjdump -sass) is compared, with the anonymous
namespace's per-file hash taken out of the names.

    python3 scripts/rk_header_sass.py --old OLD/rk_fixed_grid.cu \\
        [--new latentdiffeq_torch/csrc/rk_fixed_grid.cu]

OLD is an earlier tree's source (``git archive <commit>`` unpacked under
build/). Needs nvcc and cuobjdump (the machine with the card). Prints one
line a kernel that differs and a summary line; exits 1 if any differs.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from latentdiffeq_torch.ops import _build  # noqa: E402

# the anonymous namespace's and internal linkage's per-file hashes
_HASHES = re.compile(r"(_GLOBAL__N__|_INTERNAL_)[0-9a-f]+_\d+_\w+?_cu_"
                     r"[0-9a-f]+")


def sass(src: str, out_dir: str):
    """{kernel: its SASS lines} of ``src`` built as the library is."""
    lib = os.path.join(out_dir, os.path.basename(os.path.dirname(src))
                       + "_" + os.path.basename(src) + ".so")
    subprocess.run([_build._nvcc(), *_build._flags("rk_fixed_grid"),
                    f"-I{os.path.dirname(os.path.abspath(src))}", src,
                    "-o", lib], check=True, capture_output=True)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        line = _HASHES.sub("ANON", line)
        if line.strip().startswith("Function :"):
            cur = line.split(":", 1)[1].strip()
            funcs[cur] = []
        elif cur is not None and line.strip():
            # drop the address comment, keep the instruction and encoding
            funcs[cur].append(re.sub(r"/\*[0-9a-f]{4}\*/", "", line).strip())
    return funcs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True)
    ap.add_argument("--new", default=os.path.join(_build.CSRC_DIR,
                                                  "rk_fixed_grid.cu"))
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "a"))
        os.makedirs(os.path.join(tmp, "b"))
        old = sass(args.old, os.path.join(tmp, "a"))
        new = sass(args.new, os.path.join(tmp, "b"))
    differ = sorted(k for k in set(old) | set(new)
                    if old.get(k) != new.get(k))
    for k in differ:
        print(f"differs: {k} (old {len(old.get(k, []))} lines, new "
              f"{len(new.get(k, []))})")
    print(f"rk_header_sass: {len(old)} kernels in the old build, {len(new)} "
          f"in the new, {len(set(old) & set(new)) - len(set(differ) & set(old) & set(new))} "
          f"identical in SASS, {len(differ)} differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
