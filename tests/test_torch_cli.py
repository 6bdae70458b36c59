"""The port's CLI (genestrip_tpu_torch/cli.py) against the JAX package's: one
db zip written by genestrip_tpu's Database.save, the `match` goal run by
both CLIs (the port on the CPU), and the output files compared.

Tolerance: exact equality of the match CSV, Kraken-style output and
filtered fastq bytes.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import write_fastq  # noqa: E402
from test_match_parity import build_world, make_reads  # noqa: E402

from genestrip_tpu import cli as jcli  # noqa: E402
from genestrip_tpu.store.database import Database  # noqa: E402
from genestrip_tpu_torch import cli as tcli  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _db_and_fastq(tmp_path, seed):
    rng = np.random.default_rng(seed)
    table, small, genomes = build_world(tmp_path / "world", rng)
    db = tmp_path / "db.zip"
    Database(table, small, {"source": "test"}).save(db, include_hash=True)
    reads = make_reads(rng, genomes, n_reads=700)
    fq = write_fastq(tmp_path / "reads.fastq", reads)
    return db, fq


@pytest.mark.parametrize("conf", [
    ["matchBatchSize=64"],
    ["matchBatchSize=1024", "minKMersForClass=2", "maxReadTaxErrorCount=0.5",
     "writeFilteredFastq=true", "gzipFastqOutput=false"],
], ids=["small_batches", "one_join_batch"])
def test_match_outputs_equal_jax_cli(tmp_path, conf):
    db, fq = _db_and_fastq(tmp_path, 7)
    outs = {}
    for name, run in (("jax", lambda a: jcli.main(a)),
                      ("port", lambda a: tcli.main(a, device=torch.device("cpu")))):
        base = tmp_path / name
        argv = ["-d", str(base), "-db", str(db), "-f", str(fq), "-k", "key1",
                "-C", "writeKrakenStyleOut=true", "-C", "progressBar=false"]
        for c in conf:
            argv += ["-C", c]
        assert run(argv + ["proj", "match"]) == 0
        proj = base / "projects" / "proj"
        outs[name] = {p.relative_to(proj): p.read_bytes()
                      for p in proj.rglob("*") if p.is_file()}
    assert set(outs["port"]) == set(outs["jax"])
    names = {str(p) for p in outs["jax"]}
    assert "csv/proj_match_key1.csv" in names
    assert "krakenout/proj_matchres_key1.out" in names
    for rel, data in outs["jax"].items():
        assert outs["port"][rel] == data, rel
    csv = outs["port"][Path("csv/proj_match_key1.csv")].decode()
    assert len(csv.splitlines()) > 3           # classified taxa were reported


def test_match_is_skipped_when_its_csv_exists(tmp_path):
    db, fq = _db_and_fastq(tmp_path, 8)
    argv = ["-d", str(tmp_path / "b"), "-db", str(db), "-f", str(fq), "-k", "k",
            "-C", "progressBar=false", "proj", "match"]
    assert tcli.main(argv, device=torch.device("cpu")) == 0
    csv = tmp_path / "b" / "projects" / "proj" / "csv" / "proj_match_k.csv"
    csv.write_bytes(b"kept")
    assert tcli.main(argv, device=torch.device("cpu")) == 0
    assert csv.read_bytes() == b"kept"


@pytest.mark.parametrize("argv", [
    ["proj", "db"],
    ["-db", "x.zip", "proj", "match", "filter"],
    ["proj", "match"],
    ["-db", "x.zip", "-t", "clean", "proj", "match"],
    ["proj"],
], ids=["other_goal", "extra_goal", "no_db", "clean_target", "show"])
def test_other_goals_are_refused(tmp_path, capsys, argv):
    rc = tcli.main(["-d", str(tmp_path)] + argv, device=torch.device("cpu"))
    assert rc == 2
    err = capsys.readouterr().err
    assert "not ported to genestrip_tpu_torch yet" in err and "ROADMAP" in err
    assert not (tmp_path / "projects").exists()


def test_module_entry_needs_cuda(tmp_path):
    """`python -m genestrip_tpu_torch.cli` runs on CUDA only; without a card
    it refuses to start rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "genestrip_tpu_torch.cli",
                        "-d", str(tmp_path), "-db", "x.zip", "proj", "match"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA" in r.stderr
