"""CLI for evamlint over the port: ``python -m evam_tpu_torch.analysis``.

Exit codes: 0 clean (everything allowlisted or nothing found),
1 unallowlisted findings, 2 analyzer/allowlist malfunction.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

from .core import (Allowlist, AllowlistError, PASS_IDS, repo_root,
                   report_json, run_passes)

ALLOWLIST = Path(__file__).resolve().parent / "allowlist.toml"


def changed_files(root: Path, base: str) -> set[str] | None:
    """Repo-relative files changed vs ``base`` (merge-base diff plus
    the working tree), for ``--diff`` pre-commit runs."""
    out: set[str] = set()
    for args in (["git", "diff", "--name-only", f"{base}...HEAD"],
                 ["git", "diff", "--name-only", "HEAD"],
                 ["git", "ls-files", "-o", "--exclude-standard"]):
        try:
            r = subprocess.run(args, cwd=root, capture_output=True,
                               text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if r.returncode != 0:
            return None
        out.update(l.strip() for l in r.stdout.splitlines() if l.strip())
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="evamlint",
        description="project-invariant static analysis for evam_tpu_torch")
    ap.add_argument("--json", metavar="PATH",
                    help="write the machine-readable report here "
                         "('-' for stdout)")
    ap.add_argument("--passes", "--pass", dest="passes",
                    default=",".join(PASS_IDS),
                    help=f"comma list from {','.join(PASS_IDS)}")
    ap.add_argument("--diff", nargs="?", const="main", default=None,
                    metavar="BASE",
                    help="only report findings in files changed vs BASE "
                         "(default main) or uncommitted — fast local "
                         "pre-commit mode; stale-allowlist checking is "
                         "skipped")
    ap.add_argument("--allowlist", default=str(ALLOWLIST),
                    help="override the allowlist path (tests)")
    ap.add_argument("--root", default=None,
                    help="override the repo root (tests)")
    args = ap.parse_args(argv)

    root = Path(args.root).resolve() if args.root else repo_root()
    try:
        allow = Allowlist.load(Path(args.allowlist))
    except AllowlistError as exc:
        print(f"evamlint: bad allowlist: {exc}", file=sys.stderr)
        return 2

    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    try:
        raw = run_passes(root, passes)
    except Exception as exc:  # analyzer bug — never report as "clean"
        print(f"evamlint: internal error: {exc!r}", file=sys.stderr)
        return 2

    allowed = [f for f in raw if allow.matches(f)]
    findings = [f for f in raw if f not in allowed]

    stale: list[dict] = []
    if args.diff is not None:
        changed = changed_files(root, args.diff)
        if changed is None:
            print("evamlint: --diff needs a working `git`; running on "
                  "the full repo", file=sys.stderr)
        else:
            findings = [f for f in findings if f.file in changed]
    else:
        # entries for passes that were not selected this run cannot be
        # judged stale — only a full-pass run can retire them
        stale = [e for e in allow.stale_entries()
                 if e["pass"] in passes]

    human = sys.stdout
    if args.json:
        payload = report_json(findings, allowed, stale)
        if args.json == "-":
            print(payload)
            human = sys.stderr  # keep stdout valid JSON
        else:
            Path(args.json).write_text(payload + "\n", encoding="utf-8")

    for f in findings:
        print(f"{f.location()}: [{f.pass_id}] {f.message}  "
              f"(ident: {f.ident})", file=human)
    for e in stale:
        print(f"{allow.path}: stale allowlist entry "
              f"(pass={e['pass']!r}, ident={e['ident']!r}) matches no "
              f"finding — delete it", file=human)
    if findings or stale:
        print(f"evamlint: {len(findings)} finding(s), "
              f"{len(stale)} stale allowlist entr(y/ies), "
              f"{len(allowed)} allowlisted", file=sys.stderr)
        return 1
    print(f"evamlint: clean ({len(allowed)} allowlisted suppression(s) "
          f"across passes: {', '.join(passes)})", file=human)
    return 0


if __name__ == "__main__":
    sys.exit(main())
