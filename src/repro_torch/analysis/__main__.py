"""``python -m repro_torch.analysis`` — lint Datalog programs from the shell.

Exit status: 0 clean (or warnings without ``--strict``), 1 diagnostics
at or above the failure threshold, 2 usage error.

Examples::

    python -m repro_torch.analysis examples/datalog/*.dl
    python -m repro_torch.analysis --json --outputs tc program.dl
    echo 'p(x) :- e(x,y).' | python -m repro_torch.analysis --strict -
    python -m repro_torch.analysis --adorn 'tc^bf' program.dl
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import AnalysisConfig, RewriteConfig, analyze_program


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Datalog program linter and rewrite explainer.",
    )
    ap.add_argument("files", nargs="+", help="Datalog source files ('-' = stdin)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument(
        "--outputs",
        default=None,
        help="comma-separated output predicates (enables DL103 reachability)",
    )
    ap.add_argument(
        "--no-rewrite",
        action="store_true",
        help="skip the rewrite pipeline (errors/lints only)",
    )
    ap.add_argument(
        "--no-lint",
        action="store_true",
        help="errors only: skip DL1xx warning passes",
    )
    ap.add_argument(
        "--strict",
        action="store_true",
        help="treat warnings as failures (CI gate)",
    )
    ap.add_argument(
        "--show-rewritten",
        action="store_true",
        help="print the rewritten program after the diagnostics",
    )
    ap.add_argument(
        "--adorn",
        default=None,
        metavar="PRED^PATTERN",
        help="print the adorned + magic program for one binding pattern "
        "(e.g. tc^bf; pred/pattern also accepted); with --json the "
        "transform rides in each file's 'demand' key",
    )
    return ap


def run(argv: list[str]) -> int:
    args = build_parser().parse_args(argv)
    outputs = (
        tuple(s.strip() for s in args.outputs.split(",") if s.strip())
        if args.outputs
        else None
    )
    rewrite = (
        RewriteConfig(False, False, False, False)
        if args.no_rewrite
        else RewriteConfig()
    )
    config = AnalysisConfig(rewrite=rewrite, lint=not args.no_lint)

    adorn: tuple[str, str] | None = None
    if args.adorn is not None:
        sep = "^" if "^" in args.adorn else "/"
        pred, _, pattern = args.adorn.partition(sep)
        if not pred or not pattern:
            print(
                f"--adorn {args.adorn!r}: expected PRED^PATTERN (e.g. tc^bf)",
                file=sys.stderr,
            )
            return 2
        adorn = (pred, pattern)

    failed = False
    json_out = []
    for path in args.files:
        try:
            source = sys.stdin.read() if path == "-" else open(path).read()
        except OSError as e:
            print(f"{path}: {e}", file=sys.stderr)
            return 2
        name = "<stdin>" if path == "-" else path
        report = analyze_program(source, config, outputs=outputs)
        if report.errors or (args.strict and report.warnings):
            failed = True
        transform = None
        if adorn is not None and report.rewritten is not None:
            from repro_torch.analysis import demand_transform

            try:
                transform = demand_transform(report.rewritten, *adorn)
            except ValueError as e:     # unknown pred / malformed pattern
                print(f"{name}: --adorn: {e}", file=sys.stderr)
                return 2
        if args.json:
            doc = {"file": name, **report.to_dict()}
            if transform is not None:
                doc["demand"] = transform.to_dict()
            json_out.append(doc)
        else:
            print(report.render(name))
            if args.show_rewritten and report.rewritten is not None:
                print("--- rewritten ---")
                print(repr(report.rewritten))
            if transform is not None:
                print("--- demand ---")
                print(transform.render())
    if args.json:
        print(json.dumps(json_out, indent=2))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
