"""The port runs where JAX is absent, as on the GPU machine: in a subprocess
where `import jax` fails, every module of genestrip_tpu_torch and
chip_smoke.py imports, and the port's own TableBuilder/build_hash/
Database.save build a tiny db that the port's CLI matches on the CPU.
"""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r'''
import importlib, pkgutil, sys
sys.modules["jax"] = None                 # any `import jax` now fails
sys.path.insert(0, sys.argv[1])
import genestrip_tpu_torch
names = [m.name for m in pkgutil.walk_packages(genestrip_tpu_torch.__path__,
                                                "genestrip_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke                          # work sits under __main__
bad = [m for m in sys.modules if m == "genestrip_tpu" or m.startswith("genestrip_tpu.")]
assert not bad, bad

from pathlib import Path
import numpy as np, torch
from genestrip_tpu_torch.ops.kmer import window_kmers_np
from genestrip_tpu_torch.store.database import Database
from genestrip_tpu_torch.store.table import TableBuilder
from genestrip_tpu_torch.tax.small import SmallTaxTree
from genestrip_tpu_torch.utils.dna import DECODE_TABLE
from genestrip_tpu_torch import cli

tmp = Path(sys.argv[2])
rng = np.random.default_rng(1)
genome = rng.integers(0, 4, 3000).astype(np.uint8)
kmers, valid = window_kmers_np(genome, 31)
b = TableBuilder(31)
b.add(kmers[valid][:1500], "11")
b.add(kmers[valid][1500:], "12")
taxids = ["1", "10", "11", "12"]
tree = SmallTaxTree(taxids, taxids, [-1] * 4, [-1, 0, 1, 1], np.zeros(4, bool))
Database(b.build(), tree, {}).save(tmp / "db.zip", include_hash=True)
seqs = [bytes(DECODE_TABLE[genome[s:s + 150]]) for s in range(0, 2800, 70)]
with open(tmp / "r.fastq", "wb") as f:
    for i, s in enumerate(seqs):
        f.write(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
rc = cli.main(["-d", str(tmp / "base"), "-db", str(tmp / "db.zip"), "-f",
               str(tmp / "r.fastq"), "-k", "k", "-C", "progressBar=false",
               "-C", "writeKrakenStyleOut=true", "p", "match"],
              device=torch.device("cpu"))
assert rc == 0
csv = (tmp / "base/projects/p/csv/p_match_k.csv").read_text()
assert "11" in csv and "12" in csv, csv
print("NOJAX_OK", len(names))
'''


def test_port_imports_and_matches_without_jax(tmp_path):
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(REPO), str(tmp_path)],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NOJAX_OK" in r.stdout
