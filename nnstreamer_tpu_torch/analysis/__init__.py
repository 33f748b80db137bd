"""Static analysis for nnstreamer_tpu_torch: ``nns-lint``.

Two halves sharing one diagnostics model:

- the **pipeline verifier** (:func:`verify_description`,
  :func:`verify_pipeline`) statically checks nns-launch descriptions —
  graph shape, caps/dtype/shape propagation, policy conflicts — without
  constructing any runtime state (codes ``NNS0xx``);
- the **project AST lint** (:func:`lint_tree`) enforces codebase
  invariants like monotonic-clock usage and no blocking calls under
  locks (codes ``NNS1xx``);
- the **whole-program concurrency analysis**
  (:func:`lint_concurrency`) infers lock-guarded attributes, builds the
  project-wide lock-ordering graph (:func:`static_lock_graph` — the
  graph the runtime witness ``obs/lockgraph.py`` cross-checks), and
  flags check-then-act races and foreign calls under lock (codes
  ``NNS2xx``).

See ``docs/linting.md`` for the full diagnostic-code table, the JSON
output schema, and the pragma syntax.
"""

from nnstreamer_tpu_torch.analysis.astlint import (     # noqa: F401
    lint_file,
    lint_source,
    lint_tree,
)
from nnstreamer_tpu_torch.analysis.concurrency import (  # noqa: F401
    lint_concurrency,
    lint_concurrency_source,
    lint_concurrency_sources,
    static_lock_graph,
)
from nnstreamer_tpu_torch.analysis.diagnostics import (  # noqa: F401
    CODE_TABLE,
    ERROR,
    INFO,
    WARNING,
    Diagnostic,
    Location,
    has_errors,
    render_json,
    render_text,
    sort_diagnostics,
    summarize,
)
from nnstreamer_tpu_torch.analysis.verify import (       # noqa: F401
    verify_description,
    verify_pipeline,
)

__all__ = [
    "CODE_TABLE", "Diagnostic", "Location",
    "ERROR", "WARNING", "INFO",
    "has_errors", "render_json", "render_text", "sort_diagnostics",
    "summarize",
    "verify_description", "verify_pipeline",
    "lint_file", "lint_source", "lint_tree",
    "lint_concurrency", "lint_concurrency_source",
    "lint_concurrency_sources", "static_lock_graph",
]
