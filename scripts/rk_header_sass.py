"""Show that two sources of the batched RK library compile to the same
machine code: each is built with the library's own flags and every
kernel's SASS (cuobjdump -sass) is compared, with the anonymous
namespace's per-file hash taken out of the names.

    python3 scripts/rk_header_sass.py --old OLD/rk_fixed_grid.cu \\
        [--new latentdiffeq_torch/csrc/rk_fixed_grid.cu] [--generated]

OLD is an earlier tree's source (``git archive <commit>`` unpacked under
build/). With ``--generated`` the generated instances of that tree's
chip_smoke.py phase 4l (the functors traced from its fields and the
lane-group Kuramoto kernels at 7 oscillators) are also built as each tree
makes them, its code generator's source against its header
(rk_fixed_grid.cuh beside OLD, the current one), and compared the same
way. Needs nvcc and cuobjdump (the
machine with the card). Prints one line a kernel that differs and a
summary line a library; exits 1 if any differs.
"""
from __future__ import annotations

import argparse
import json
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


def sass(src: str, out_dir: str, flags=None, include=None):
    """{kernel: its SASS lines} of ``src`` built as the library is (or
    with ``flags`` and the header directory ``include``)."""
    lib = os.path.join(out_dir, os.path.basename(os.path.dirname(src))
                       + "_" + os.path.basename(src) + ".so")
    flags = _build._flags("rk_fixed_grid") if flags is None else flags
    include = include or os.path.dirname(os.path.abspath(src))
    subprocess.run([_build._nvcc(), *flags, f"-I{include}", src,
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


def compare(what, old, new):
    """Print the kernels that differ and a summary line; their count."""
    differ = sorted(k for k in set(old) | set(new)
                    if old.get(k) != new.get(k))
    for k in differ:
        print(f"differs: {what}: {k} (old {len(old.get(k, []))} lines, new "
              f"{len(new.get(k, []))})")
    same = len(set(old) & set(new)) - len(set(differ) & set(old) & set(new))
    print(f"rk_header_sass: {what}: {len(old)} kernels in the old build, "
          f"{len(new)} in the new, {same} identical in SASS, {len(differ)} "
          f"differ")
    return len(differ)


_SOURCES = """
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
from latentdiffeq_torch.ops import rhs_codegen, rhs_trace
out = {}
for label, (f, dim, pdim, *_) in chip_smoke.gen_fields().items():
    if label in sys.argv[2:]:
        out[label] = (rhs_codegen.kuramoto_source(dim)
                      if label.startswith("kuramoto") else
                      rhs_codegen.kernel_source(
                          rhs_trace.trace_field(f, dim, pdim)))
print(json.dumps(out))
"""


def generated_sources(root, labels):
    """label -> source of chip_smoke.py's phase 4l instance, as the tree at
    ``root`` generates it (in a process of its own, on that tree's
    package)."""
    out = subprocess.run([sys.executable, "-c", _SOURCES, root, *labels],
                         cwd=root, check=True, capture_output=True,
                         text=True, env={**os.environ,
                                         "PYTHONPATH": root}).stdout
    return json.loads(out.strip().splitlines()[-1])


def phase_4l_labels(root):
    """The labels of chip_smoke.py's phase 4l instances in the tree at
    ``root`` (the ones an earlier tree built: Lorenz-96 at 40 and
    Kuramoto at 64, phase 4m's, are new)."""
    out = subprocess.run(
        [sys.executable, "-c", "import json, sys; sys.path.insert(0, "
         "sys.argv[1]); import chip_smoke; print(json.dumps(["
         "k for k in chip_smoke.gen_fields() if k not in getattr("
         "chip_smoke, 'WIDE', ())]))", root], cwd=root, check=True,
        capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": root}).stdout
    return json.loads(out.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True)
    ap.add_argument("--new", default=os.path.join(_build.CSRC_DIR,
                                                  "rk_fixed_grid.cu"))
    ap.add_argument("--generated", action="store_true")
    args = ap.parse_args(argv)
    differ = 0
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "a"))
        os.makedirs(os.path.join(tmp, "b"))
        old = sass(args.old, os.path.join(tmp, "a"))
        new = sass(args.new, os.path.join(tmp, "b"))
        differ += compare("rk_fixed_grid.cu", old, new)
        if args.generated:
            old_dir = os.path.dirname(os.path.abspath(args.old))
            new_dir = os.path.dirname(os.path.abspath(args.new))
            trees = [os.path.dirname(os.path.dirname(d))
                     for d in (old_dir, new_dir)]
            labels = phase_4l_labels(trees[0])
            texts = [generated_sources(t, labels) for t in trees]
            for label in labels:
                got = []
                for d, inc, text in zip("ab", (old_dir, new_dir), texts):
                    src = os.path.join(tmp, d, f"gen_{label}.cu")
                    with open(src, "w") as f:
                        f.write(text[label])
                    got.append(sass(src, os.path.join(tmp, d),
                                    _build.GEN_FLAGS, inc))
                differ += compare(label, *got)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
