"""Generate GOKU-net_pendulum_tutorial.ipynb from tutorial.py, executed
(counterpart of examples/tutorial/make_notebook.py).

tutorial.py is the single source: its ``main`` reads top to bottom as the
notebook. The section banners of ``main``'s body become markdown cells,
the code between them runs in-process (``main``'s arguments from this
script's command line) with its printed output captured into the cell,
and the figures a cell writes become inline images.

    python -m latentdiffeq_torch.examples.tutorial.make_notebook \\
        [--epochs N] [--device cpu]

Needs ``nbformat``, imported when the notebook is made.
"""
from __future__ import annotations

import base64
import io
import os
import re
import textwrap
from contextlib import redirect_stdout

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "tutorial.py")
OUT = os.path.join(HERE, "output", "GOKU-net_pendulum_tutorial.ipynb")
BANNER = re.compile(r"^# -{5,}\s*$")

__all__ = ["split_sections", "main"]


def _main_body(text: str) -> str:
    """``main``'s body, dedented, without its final ``return``."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("def main("))
    body = []
    for ln in lines[start + 1:]:
        if ln.strip() and not ln.startswith(" "):
            break
        body.append(ln)
    while body and not body[-1].strip():
        body.pop()
    if body and body[-1].strip().startswith("return "):
        body.pop()
    return textwrap.dedent("\n".join(body))


def split_sections(text: str):
    """(kind, source) chunks of tutorial.py: the module docstring as the
    intro, then ``main``'s body split at its banner-comment blocks, which
    become markdown; everything between them is code."""
    mod = re.match(r'"""(.*?)"""\s*', text, re.S)
    intro = mod.group(1).strip() if mod else ""
    lines = _main_body(text).splitlines()

    chunks = [("md", "# GOKU-net pendulum tutorial\n\n" + intro)]
    code, i = [], 0
    while i < len(lines):
        if BANNER.match(lines[i]):
            if any(s.strip() for s in code):
                chunks.append(("code", "\n".join(code).strip("\n")))
            code = []
            i += 1
            md = []
            while i < len(lines) and lines[i].startswith("#") \
                    and not BANNER.match(lines[i]):
                md.append(lines[i].lstrip("# "))
                i += 1
            if i < len(lines) and BANNER.match(lines[i]):
                i += 1
            chunks.append(("md", "## " + "\n".join(md).strip()))
        else:
            code.append(lines[i])
            i += 1
    if any(s.strip() for s in code):
        chunks.append(("code", "\n".join(code).strip("\n")))
    return chunks


def _png_output(nbf, path):
    with open(path, "rb") as f:
        data = base64.b64encode(f.read()).decode()
    return nbf.v4.new_output("display_data", data={"image/png": data})


def main(argv=None):
    import nbformat as nbf

    from latentdiffeq_torch.examples.tutorial import tutorial

    chunks = split_sections(open(SRC).read())
    ns = dict(vars(tutorial), argv=argv)
    nb = nbf.v4.new_notebook()
    nb.metadata["kernelspec"] = {"name": "python3",
                                 "display_name": "Python 3",
                                 "language": "python"}
    n_exec = 0
    for kind, src in chunks:
        if kind == "md":
            nb.cells.append(nbf.v4.new_markdown_cell(src))
            continue
        cell = nbf.v4.new_code_cell(src)
        seen = len(ns.get("figures", ()))
        buf = io.StringIO()
        with redirect_stdout(buf):
            exec(compile(src, SRC, "exec"), ns)  # noqa: S102 (own source)
        n_exec += 1
        cell.execution_count = n_exec
        out = buf.getvalue()
        if out:
            cell.outputs.append(nbf.v4.new_output("stream", name="stdout",
                                                  text=out))
        for path in ns.get("figures", [])[seen:]:
            cell.outputs.append(_png_output(nbf, path))
        nb.cells.append(cell)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    nbf.write(nb, OUT)
    print(f"wrote {OUT}: {len(nb.cells)} cells, {n_exec} executed")
    return OUT


if __name__ == "__main__":
    main()
