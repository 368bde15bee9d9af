"""Metric-name lint of the port: the counterpart of the JAX package's
``tools/check_metric_names.py``, a thin command line over
:func:`.registries.metric_findings`.

Rules:

- metric families are ``snake_case`` with a unit suffix (``_total`` /
  ``_seconds`` / ``_bytes``, or ``_ratio`` for unitless 0..1
  fractions); dotted tails are label encodings checked on the family;
- one family, one type (a name cannot be both counter and gauge);
- doc drift: every family in ``docs/torch_observability.md`` exists in
  code (a registry call site or an exposition-only series), and every
  registered family is documented.

Usage::

    python -m presto_tpu_torch._devtools.analyze.metric_names [src_dir ...]
    python -m presto_tpu_torch._devtools.analyze.metric_names --docs PATH
    python -m presto_tpu_torch._devtools.analyze.metric_names --no-docs

Exit 0 when clean, 1 on errors.
"""
from __future__ import annotations

import argparse
import os
import sys

from . import registries
from .base import PKG, REPO


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="metric-name lint of "
                                             "presto_tpu_torch")
    ap.add_argument("src", nargs="*", default=None,
                    help="source directories (default: presto_tpu_torch/)")
    ap.add_argument("--docs", default=None, metavar="PATH",
                    help="document to drift-check (default: "
                         "docs/torch_observability.md)")
    ap.add_argument("--no-docs", action="store_true",
                    help="skip the doc-drift check")
    args = ap.parse_args(argv)
    # user-given directories resolve against the working directory
    # (walk_py would anchor a relative path at the repo root)
    roots = [os.path.abspath(p) for p in args.src] if args.src \
        else [os.path.join(REPO, PKG)]
    doc = None if args.no_docs else (
        args.docs or os.path.join(REPO, registries.OBS_DOC))
    findings = registries.metric_findings(roots, REPO, doc_path=doc)
    if findings:
        for f in findings:
            print(f.render(), file=sys.stderr)
        print(f"{len(findings)} metric-name error(s)", file=sys.stderr)
        return 1
    print("ok: metric naming, types and docs consistent")
    return 0


if __name__ == "__main__":
    sys.exit(main())
