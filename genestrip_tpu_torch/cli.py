"""Command-line interface of the port:
`python -m genestrip_tpu_torch.cli -db <zip> -f <fastq,...> -k <key> [-r dir]
[-C key=value ...] <project> match`.

It takes the JAX CLI's parser (genestrip_tpu/cli.py build_parser) and runs
the `match` goal for a database given with `-db`, as genestrip_tpu's
`_MatchResGoal`/`_MatchGoal` do (genestrip_tpu/maker.py): same config keys,
same output paths, same CSV and Kraken-style bytes. The goal DAG of
`GSMaker` (database builds, the other goals, `match` without `-db`) is not
ported yet; asking for it exits with an error that names its ROADMAP item.

`main(argv, device)` runs on the given torch device. `python -m` runs it on
CUDA and refuses to start when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import glob as globmod
import logging
import os
import sys
from pathlib import Path

import torch

from genestrip_tpu_torch import __version__
from genestrip_tpu_torch.io.streams import StreamingResource, open_output
from genestrip_tpu_torch.match.matcher import Matcher
from genestrip_tpu_torch.match.pipeline import MatchConfig
from genestrip_tpu_torch.project import Common, Project
from genestrip_tpu_torch.report.reporter import write_match_report
from genestrip_tpu_torch.store.database import Database

NOT_PORTED = ("is not ported to genestrip_tpu_torch yet: the goal DAG "
              "(GSMaker) and its other goals are ROADMAP queue 1, item 2")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="genestrip-tpu",
        description="TPU-native metagenomic k-mer classification engine "
                    "(Genestrip-compatible projects and goals)")
    ap.add_argument("-v", action="store_true", help="Print version.")
    ap.add_argument("-d", metavar="base dir", default="./data",
                    help="Base directory for all data files (default './data').")
    ap.add_argument("-t", metavar="target", default="make",
                    choices=["make", "clean", "cleanall", "cleantotal"],
                    help="Generation target ('make', 'clean', 'cleanall' or 'cleantotal').")
    ap.add_argument("-f", metavar="fqfile1,fqfile2,...",
                    help="Fastq files (or URLs) to match or filter, separated by ','.")
    ap.add_argument("-k", metavar="key", help="Key for given fastq files.")
    ap.add_argument("-m", metavar="fqmap", help="Mapping file '<key> <path_or_URL>' per line.")
    ap.add_argument("-r", metavar="res dir", help="Directory for result CSV files.")
    ap.add_argument("-db", metavar="database", help="Path to database file (use without project context).")
    ap.add_argument("-tx", metavar="taxids", help="Tax ids for db2fastq, separated by ','.")
    ap.add_argument("-C", metavar="key=value", action="append", default=[],
                    help="Configuration parameter override (repeatable).")
    ap.add_argument("-ll", action="store_true", help="Download URL fastqs to common dir.")
    ap.add_argument("-l", action="store_true", help="Download URL fastqs to project dir.")
    ap.add_argument("-i", action="store_true",
                    help="Make goals independently (release memory between them).")
    ap.add_argument("project", nargs="?", help="Project name.")
    ap.add_argument("goals", nargs="*", help="Goals to run (default: show).")
    return ap


def _refuse(what: str) -> int:
    print(f"{what} {NOT_PORTED}", file=sys.stderr)
    return 2


def fastq_map(project: Project, fastq_args: list[str],
              key: str | None) -> dict[str, list]:
    """Parse -f into {key: [StreamingResource]} (genestrip_tpu/maker.py
    GSMaker._fastq_map without the -m map file)."""
    out: dict[str, list] = {}

    def resolve(spec: str) -> list:
        if "://" in spec:
            gz = True if project["alwaysAssumeGzip"] else None
            return [StreamingResource(spec, assume_gzip=gz)]
        for base in (Path("."), project.fastq_dir, project.common.fastq_dir,
                     project.common.base_dir / "fastq"):
            matches = sorted(globmod.glob(str(base / spec))) if any(
                ch in spec for ch in "*?[") else (
                [str(base / spec)] if (base / spec).exists() else [])
            if matches:
                return [StreamingResource(mp) for mp in matches]
        if Path(spec).exists():
            return [StreamingResource(spec)]
        raise FileNotFoundError(f"fastq not found: {spec}")

    for spec in fastq_args:
        k = key
        if k is None:
            k = project.file_base_name(os.path.basename(spec.split("?")[0]))
        out.setdefault(k, []).extend(resolve(spec))
    return out


def run_match(project: Project, fastqs: dict[str, list],
              device: torch.device) -> None:
    """The `match` goal for a `-db` database: per key, match its resources
    and write the CSV (plus the Kraken-style and filtered-fastq outputs the
    config asks for). As in the reference, the goal is made when every key's
    CSV exists, and an existing CSV is not rewritten."""
    p = project
    csvs = {key: p.output_file("match", "csv", key=key) for key in fastqs}
    if csvs and all(f.exists() for f in csvs.values()):
        return
    db = Database.load(p.db_file)
    cfg = MatchConfig(
        k=db.k,
        max_paths=p["maxClassificationPaths"],
        classify=p["classifyReads"],
        with_unique=p["countUniqueKMers"],
        with_counts=p["maxKMerResCounts"] > 0,
        max_read_tax_error=p["maxReadTaxErrorCount"],
        max_read_class_error=p["maxReadClassErrorCount"],
        threshold=p["minKMersForClass"],
        return_labels=False,
    )
    for key in fastqs:
        matcher = Matcher(db.table, db.tree, cfg, device, db_md5=db.md5 or "",
                          batch_size=p["matchBatchSize"],
                          max_kmer_res_counts=p["maxKMerResCounts"],
                          write_all=p["writeAll"],
                          prebuilt_hash=db.prebuilt_hash)
        matcher.with_probs = p["withProbs"]
        matcher.progress = p["progressBar"]
        matcher.progress_interval_ms = p["progressBarUpdateMs"]
        matcher.threads = p["threads"]
        filtered = kraken = None
        try:
            if p["writeFilteredFastq"]:
                f = p.output_file("matchres", "fastq_res", key=key,
                                  gzip=p["gzipFastqOutput"])
                f.parent.mkdir(parents=True, exist_ok=True)
                filtered = open_output(f)
            if p["writeKrakenStyleOut"]:
                f = p.output_file("matchres", "kraken_out", key=key)
                f.parent.mkdir(parents=True, exist_ok=True)
                kraken = open_output(f)
            res = matcher.run(fastqs[key], filtered_out=filtered,
                              kraken_out=kraken)
        finally:
            if filtered:
                filtered.close()
            if kraken:
                kraken.close()
        res.complete_results(db.tree, db.stats())
        if not csvs[key].exists():
            csvs[key].parent.mkdir(parents=True, exist_ok=True)
            write_match_report(res, csvs[key])


def main(argv=None, device: torch.device | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.v:
        print(f"genestrip-tpu {__version__}")
        return 0
    if device is None:
        raise ValueError("genestrip_tpu_torch.cli.main needs a torch device")
    if not args.project:
        print("Missing project name. Use -h for help.", file=sys.stderr)
        return 2
    goals = args.goals or ["show"]
    if goals != ["match"]:
        other = [g for g in goals if g != "match"]
        return _refuse(f"goal(s) {' '.join(other or goals)}:")
    if args.t != "make":
        return _refuse(f"target -t {args.t}:")
    if not args.db:
        return _refuse("match without -db (database from a project build):")
    if args.m or args.l or args.ll:
        return _refuse("fastq map files and fastq downloads (-m, -l, -ll):")

    overrides = {}
    for kv in args.C:
        k, _, v = kv.partition("=")
        overrides[k.strip()] = v.strip()
    logging.basicConfig(
        level=getattr(logging, overrides.get("logLevel", "info").upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")

    project = Project(Common(args.d), args.project, overrides=overrides,
                      db_path=args.db, csv_dir=args.r)
    fastqs = fastq_map(project, args.f.split(",") if args.f else [], args.k)
    run_match(project, fastqs, torch.device(device))
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("genestrip_tpu_torch.cli runs on CUDA and found no "
                         "CUDA device; tests call main(argv, device) directly")
    sys.exit(main(device=torch.device("cuda")))
