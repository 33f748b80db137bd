"""``nns-lint-torch`` — static checks for the port's pipelines and its
project invariants (the port of the JAX package's ``nns-lint``).

Usage::

    nns-lint-torch "videotestsrc ! tensor_converter ! tensor_sink"
    nns-lint-torch -f pipeline.txt
    nns-lint-torch --self                 # AST lint nnstreamer_tpu_torch
    nns-lint-torch --concurrency          # whole-program NNS2xx pass
    nns-lint-torch --scan examples/ docs/ # verify shipped descriptions
    nns-lint-torch --format json "..."    # machine-readable output

(or ``python -m nnstreamer_tpu_torch.analysis.cli``). Descriptions are
verified against the port's registry and caps.

Exit status: 0 when no error-severity diagnostics were found, 1 when
there were (or any warnings under ``--strict``), 2 on usage errors.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List

from nnstreamer_tpu_torch.analysis.diagnostics import (
    ERROR,
    WARNING,
    Diagnostic,
    render_json,
    render_text,
)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nns-lint-torch",
        description="Static pipeline verifier and project AST lint.")
    p.add_argument("description", nargs="?",
                   help="nns-launch pipeline description to verify")
    p.add_argument("-f", "--file", metavar="PATH",
                   help="read the pipeline description from a file")
    p.add_argument("--self", dest="lint_self", action="store_true",
                   help="run the project AST lint over the "
                        "nnstreamer_tpu_torch package")
    p.add_argument("--concurrency", action="store_true",
                   help="run the whole-program concurrency analysis "
                        "(NNS2xx: guarded attributes, lock ordering, "
                        "check-then-act, foreign calls under lock) over "
                        "the nnstreamer_tpu_torch package")
    p.add_argument("--scan", nargs="+", metavar="PATH",
                   help="extract and verify pipeline descriptions from "
                        "python/markdown files or directories")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="output format (default: text)")
    p.add_argument("--strict", action="store_true",
                   help="treat warnings as failures")
    return p


def _scan_paths(paths: List[str]) -> List[Diagnostic]:
    from nnstreamer_tpu_torch.analysis.extract import extract_from_file
    from nnstreamer_tpu_torch.analysis.verify import verify_description

    diags: List[Diagnostic] = []
    for raw in paths:
        path = Path(raw)
        files = sorted(p for ext in ("*.py", "*.md")
                       for p in path.rglob(ext)) if path.is_dir() \
            else [path]
        for f in files:
            if "__pycache__" in f.parts:
                continue
            for snip in extract_from_file(f):
                diags.extend(verify_description(
                    snip.description,
                    source=f"{snip.source}:{snip.line}"))
    return diags


def main(argv=None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)

    modes = sum((bool(args.description or args.file), args.lint_self,
                 args.concurrency, bool(args.scan)))
    if modes == 0:
        parser.print_usage(sys.stderr)
        print("nns-lint-torch: give a description, -f FILE, --self, "
              "--concurrency, or --scan", file=sys.stderr)
        return 2
    if args.description and args.file:
        print("nns-lint-torch: give either a description or -f, not both",
              file=sys.stderr)
        return 2

    diags: List[Diagnostic] = []
    if args.description or args.file:
        from nnstreamer_tpu_torch.analysis.verify import verify_description

        if args.file:
            try:
                text = Path(args.file).read_text(encoding="utf-8")
            except OSError as e:
                print(f"nns-lint-torch: cannot read {args.file}: {e}",
                      file=sys.stderr)
                return 2
            diags.extend(verify_description(text, source=args.file))
        else:
            diags.extend(verify_description(args.description))
    if args.lint_self:
        from nnstreamer_tpu_torch.analysis.astlint import lint_tree

        pkg_root = Path(__file__).resolve().parent.parent
        diags.extend(lint_tree(pkg_root))
    if args.concurrency:
        from nnstreamer_tpu_torch.analysis.concurrency import lint_concurrency

        pkg_root = Path(__file__).resolve().parent.parent
        diags.extend(lint_concurrency(pkg_root))
    if args.scan:
        diags.extend(_scan_paths(args.scan))

    if args.format == "json":
        print(render_json(diags))
    else:
        print(render_text(diags))

    failing = {ERROR, WARNING} if args.strict else {ERROR}
    return 1 if any(d.severity in failing for d in diags) else 0


if __name__ == "__main__":
    sys.exit(main())
