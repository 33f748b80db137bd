"""Extract pipeline descriptions from Python sources and markdown docs.

The CI lint job verifies every launch description the repo ships — in
``examples/*.py`` and in the fenced snippets of the docs — without
executing any of it. Two extractors:

- Python: AST-walk for ``parse_launch(...)`` calls. A plain string
  literal is taken verbatim; an f-string is taken with each interpolated
  ``{expr}`` replaced by ``"0"`` (ports, counts and paths don't affect
  graph shape, which is all the verifier checks).
- Markdown: fenced ````python`` blocks go through the Python extractor;
  fenced ````bash`` blocks are scanned for ``nns-launch "<desc>"``
  invocations.

Snippets containing a literal ``...`` are placeholders, not runnable
descriptions, and are skipped.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import List, NamedTuple


class Snippet(NamedTuple):
    """One extracted description plus where it came from."""

    description: str
    source: str     # file path
    line: int       # 1-based line of the description in that file


_FENCE_RE = re.compile(r"^```(\w*)\s*$")
_NNS_LAUNCH_RE = re.compile(
    r"""nns-launch\s+(?:--?[\w-]+(?:[= ][\w./:-]+)?\s+)*["']([^"']+)["']""")


def _fstring_text(node: ast.JoinedStr) -> str:
    """Flatten an f-string, substituting "0" for every interpolation."""
    parts: List[str] = []
    for v in node.values:
        if isinstance(v, ast.Constant):
            parts.append(str(v.value))
        else:
            parts.append("0")
    return "".join(parts)


def extract_from_python(text: str, source: str,
                        line_offset: int = 0) -> List[Snippet]:
    """Descriptions passed to ``parse_launch`` in a Python source."""
    out: List[Snippet] = []
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return out
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = func.attr if isinstance(func, ast.Attribute) else \
            func.id if isinstance(func, ast.Name) else ""
        if name != "parse_launch" or not node.args:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            desc = arg.value
        elif isinstance(arg, ast.JoinedStr):
            desc = _fstring_text(arg)
        else:
            continue
        if "..." in desc:
            continue
        out.append(Snippet(desc, source, arg.lineno + line_offset))
    return out


def extract_from_markdown(text: str, source: str) -> List[Snippet]:
    """Descriptions in fenced code blocks of a markdown document."""
    out: List[Snippet] = []
    lang = None
    block: List[str] = []
    block_start = 0
    for lineno, line in enumerate(text.splitlines(), start=1):
        m = _FENCE_RE.match(line.strip())
        if m and lang is None:
            lang = m.group(1).lower()
            block = []
            block_start = lineno
            continue
        if line.strip() == "```" and lang is not None:
            body = "\n".join(block)
            if lang in ("python", "py"):
                out.extend(extract_from_python(body, source,
                                               line_offset=block_start))
            elif lang in ("bash", "sh", "shell", "console", ""):
                for i, bline in enumerate(block):
                    for m2 in _NNS_LAUNCH_RE.finditer(bline):
                        desc = m2.group(1)
                        if "..." not in desc:
                            out.append(Snippet(desc, source,
                                               block_start + 1 + i))
            lang = None
            continue
        if lang is not None:
            block.append(line)
    return out


def extract_from_file(path: Path) -> List[Snippet]:
    """Dispatch on file type; unknown extensions yield nothing."""
    text = path.read_text(encoding="utf-8")
    if path.suffix == ".py":
        return extract_from_python(text, str(path))
    if path.suffix in (".md", ".rst"):
        return extract_from_markdown(text, str(path))
    return []
