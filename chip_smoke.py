"""Smoke run of genestrip_tpu_torch on one CUDA card: builds the port's CUDA
kernels, holds each against its plain PyTorch version at the main path's
shapes, then drives the `match` goal through the port's CLI over a
16M-k-mer database and checks what comes out.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises; the run then exits non-zero
and prints no result):
  env      torch/CUDA versions, the card, its power limit (nvidia-smi)
  build    nvcc of every kernel source
  kernels  each kernel vs its plain version at the main path's shapes
           (the dense pass: NB = 2^23 buckets, R = 4 lanes, vb = 22 for a
           batch of 8192 150-bp reads against 16M k-mers; also NB = 2^24):
           equality, time, plain time (CUDA events, median of 7)
  world    the database and reads, built once and cached under
           .smoke_cache/: a 16 Mbp random genome split over 256 taxa
           (k = 31), saved as a db zip with the hash persisted, and 65,536
           reads of 150 bp, half of them drawn from the genome
  match    `python -m genestrip_tpu_torch.cli ... match` on the card, with
           the kernel launch counts taken over this run alone and
           Matcher.run timed by perf_counter
  parity   the CLI over the first 8,192 reads on the card and on the CPU
           (plain versions): CSV and Kraken-style bytes must be equal
Then the kernel summary, the card's name and power limit, and the result.
"""

from __future__ import annotations

import gzip
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from genestrip_tpu_torch import cli
from genestrip_tpu_torch.ops import _build
from genestrip_tpu_torch.ops.dense_pass import dense_pass, dense_pass_torch
from genestrip_tpu_torch.match.matcher import Matcher
from genestrip_tpu_torch.ops.kmer import window_kmers_np
from genestrip_tpu_torch.store.database import Database
from genestrip_tpu_torch.store.table import TableBuilder
from genestrip_tpu_torch.tax.small import SmallTaxTree
from genestrip_tpu_torch.utils.dna import DECODE_TABLE

ROOT = Path(__file__).resolve().parent
CACHE = ROOT / ".smoke_cache"

SEED = 7
GENOME_BP = 16_000_000
TAXA = 256
K = 31
READS = 65_536
READ_LEN = 150
HIT_FRAC = 0.5
BATCH = 8192                 # matchBatchSize default
PARITY_READS = 8192

# every kernel of the port: (name, its CUDA source, the TPU kernel it
# replaces)
KERNELS = [("dense_pass", "genestrip_tpu_torch/csrc/dense_pass.cu",
            "genestrip_tpu/ops/pallas_lookup.py:61")]
# dense-pass shapes held against the plain version: (nb_bits, R), NB =
# 2^nb_bits buckets, vb = nb_bits - 1. The first is the main path's: 16M
# k-mers size the hash to 2^23 buckets (store/hash.py build_hash), and a
# batch of 8192 reads x 162 windows puts 0.32 entries on a bucket, so R = 4
# (store/hash.py lookup_join). The second is a table twice that size.
DENSE_SHAPES = [(23, 4), (24, 4)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 7) -> float:
    """Median device time of fn() in ms, by CUDA events (after a warm-up)."""
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    env = {"phase": "env", "torch": torch.__version__,
           "cuda": torch.version.cuda, "python": sys.version.split()[0],
           "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": nvidia_smi()}
    emit(env)
    return env


def phase_build() -> None:
    t0 = time.time()
    for name, _, _ in KERNELS:
        _build.load(name)
    ptxas = {}
    for name, _, _ in KERNELS:
        log = (_build.BUILD_DIR / f"{name}.log")
        text = log.read_text() if log.exists() else ""
        ptxas[name] = [ln.strip() for ln in text.splitlines()
                       if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "ptxas": ptxas})


def planted_dense_world(rng, NB: int, R: int, vb: int):
    """Random bucket rows and scratch lanes with exact matches planted on
    a quarter of the lanes and empty slots that must not match."""
    rows = rng.integers(-2**31, 2**31, (NB, 8), dtype=np.int64).astype(np.int32)
    sh = rng.integers(-2**31, 2**31, (NB, R), dtype=np.int64).astype(np.int32)
    sw = rng.integers(0, 2**(32 - vb), (NB, R), dtype=np.int64).astype(np.int32)
    hit = rng.random((NB, R)) < 0.25
    j = rng.integers(0, 4, (NB, R))
    b, r = np.nonzero(hit)
    jj = j[b, r]
    sh[b, r] = rows[b, jj]
    sw[b, r] = ((rows[b, 4 + jj].astype(np.int64) & 0xFFFFFFFF) >> vb).astype(np.int32)
    e = b[::5], jj[::5]
    rows[e[0], 4 + e[1]] |= np.int32((1 << vb) - 1)
    return rows, sh, sw


def phase_kernels() -> dict:
    t0 = time.time()
    rng = np.random.default_rng(SEED)
    results = {}
    for nb_bits, R in DENSE_SHAPES:
        NB, vb = 1 << nb_bits, nb_bits - 1
        rows, sh, sw = (torch.from_numpy(a).cuda()
                        for a in planted_dense_world(rng, NB, R, vb))
        got = dense_pass(rows, sh, sw, vb=vb)
        want = dense_pass_torch(rows, sh, sw, vb=vb)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        found = int((got >= 0).sum())
        ms = cuda_ms(lambda: dense_pass(rows, sh, sw, vb=vb))
        plain_ms = cuda_ms(lambda: dense_pass_torch(rows, sh, sw, vb=vb))
        nbytes = NB * (32 + 12 * R)
        results[nb_bits] = {
            "name": "dense_pass", "equal": equal, "max_abs_err": err,
            "found": found, "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
            "NB": NB, "R": R, "vb": vb, "bytes": nbytes,
            "GB_per_s": round(nbytes / (ms * 1e-3) / 1e9, 1)}
        del rows, sh, sw, got, want
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernels": list(results.values()),
          "seconds": round(time.time() - t0, 3)})
    for res in results.values():
        if not res["equal"] or res["found"] == 0:
            raise RuntimeError(f"dense_pass disagrees with dense_pass_torch: {res}")
    return results


def build_tax(n_taxa: int) -> SmallTaxTree:
    """The benchmark's binary-ish taxonomy (root, n_taxa/4 inner nodes, one
    leaf per taxon), laid out in pre-order as SmallTaxTree requires. Leaf t
    carries the taxid of value t, str(1000 + t)."""
    n_inner = n_taxa // 4
    parent = [-1] + [(i - 1) // 2 for i in range(1, n_inner + 1)]
    parent += [1 + (t % n_inner) for t in range(n_taxa)]
    ids = ["1"] + [str(2000 + i) for i in range(1, n_inner + 1)]
    ids += [str(1000 + t) for t in range(n_taxa)]
    children = [[] for _ in parent]
    for i in range(1, len(parent)):
        children[parent[i]].append(i)
    order, stack = [], [0]
    while stack:
        i = stack.pop()
        order.append(i)
        stack.extend(reversed(children[i]))
    new = {old: n for n, old in enumerate(order)}
    taxids = [ids[i] for i in order]
    par = [new[parent[i]] if parent[i] >= 0 else -1 for i in order]
    return SmallTaxTree(taxids, taxids, [-1] * len(order), par,
                        np.zeros(len(order), bool))


def make_reads(genome: np.ndarray, n_reads: int, read_len: int,
               hit_frac: float, seed: int = 3):
    """Half the reads drawn from the genome, half random; shuffled.
    Returns (codes [n, read_len], is_hit [n])."""
    rng = np.random.default_rng(seed)
    n_hit = int(n_reads * hit_frac)
    starts = rng.integers(0, len(genome) - read_len, size=n_hit)
    hit_reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    rand_reads = rng.integers(0, 4, size=(n_reads - n_hit, read_len),
                              dtype=np.int64).astype(np.uint8)
    codes = np.concatenate([hit_reads, rand_reads])
    is_hit = np.arange(n_reads) < n_hit
    perm = rng.permutation(n_reads)
    return codes[perm], is_hit[perm]


def write_fastq(path: Path, codes: np.ndarray) -> None:
    qual = b"I" * codes.shape[1]
    with gzip.open(path, "wb", compresslevel=1) as f:
        for s0 in range(0, len(codes), 4096):
            txt = DECODE_TABLE[codes[s0:s0 + 4096]]      # 2-bit code -> base
            f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (s0 + j, t.tobytes(), qual)
                             for j, t in enumerate(txt)))


def phase_world() -> dict:
    t0 = time.time()
    d = CACHE / f"world_g{GENOME_BP}_t{TAXA}_k{K}_s{SEED}_r{READS}_l{READ_LEN}"
    meta_path = d / "meta.json"
    cached = meta_path.exists()
    if not cached:
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        rng = np.random.default_rng(SEED)
        genome = rng.integers(0, 4, size=GENOME_BP, dtype=np.int64).astype(np.uint8)
        kmers, valid = window_kmers_np(genome, K)
        kmers = kmers[valid]
        builder = TableBuilder(K)
        bounds = np.linspace(0, len(kmers), TAXA + 1).astype(np.int64)
        for t in range(TAXA):
            builder.add(kmers[bounds[t]:bounds[t + 1]], str(1000 + t))
        table = builder.build()
        db = Database(table, build_tax(TAXA), {})
        db.save(d / "db.zip", include_hash=True)
        codes, is_hit = make_reads(genome, READS, READ_LEN, HIT_FRAC)
        write_fastq(d / "reads.fastq.gz", codes)
        write_fastq(d / "parity.fastq.gz", codes[:PARITY_READS])
        meta = {"entries": int(table.entries),
                "nb_bits": int(db.prebuilt_hash.nb_bits),
                "hits": int(is_hit.sum()),
                "parity_hits": int(is_hit[:PARITY_READS].sum())}
        meta_path.write_text(json.dumps(meta))
    meta = json.loads(meta_path.read_text())
    emit({"phase": "world", "cached": cached, "dir": str(d.relative_to(ROOT)),
          "genome_bp": GENOME_BP, "taxa": TAXA, "k": K, "reads": READS,
          "read_len": READ_LEN, **meta, "seconds": round(time.time() - t0, 3)})
    return {"dir": d, **meta}


def run_cli(world: dict, fastq: str, device: torch.device, tag: str):
    """The port's CLI `match` goal on a fresh base dir; returns (CLI
    seconds, csv bytes, kraken bytes, seconds of each Matcher.run call).
    Matcher.run returns only once its last batch's results are on the
    host, so perf_counter around it covers the device work."""
    base = CACHE / "runs" / tag
    shutil.rmtree(base, ignore_errors=True)
    run_s = []
    run = Matcher.run

    def timed_run(self, *args, **kwargs):
        t = time.perf_counter()
        try:
            return run(self, *args, **kwargs)
        finally:
            run_s.append(time.perf_counter() - t)

    Matcher.run = timed_run
    try:
        t0 = time.perf_counter()
        rc = cli.main(["-d", str(base), "-db", str(world["dir"] / "db.zip"),
                       "-f", str(world["dir"] / fastq), "-k", tag,
                       "-C", "writeKrakenStyleOut=true", "smoke", "match"],
                      device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        Matcher.run = run
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc} on {device}")
    proj = base / "projects" / "smoke"
    csv = (proj / "csv" / f"smoke_match_{tag}.csv").read_bytes()
    kraken = (proj / "krakenout" / f"smoke_matchres_{tag}.out").read_bytes()
    return secs, csv, kraken, run_s


def classified_reads(csv: bytes) -> int:
    """Sum of the 'reads' column over the taxon rows of a match CSV."""
    lines = csv.decode().splitlines()
    col = lines[0].split(";").index("reads")
    return sum(int(ln.split(";")[col]) for ln in lines[1:]
               if ln.split(";")[0] != "0")


def phase_match(world: dict) -> dict:
    cuda = torch.device("cuda")
    dense_pass.launches = 0
    secs, csv, kraken, run_s = run_cli(world, "reads.fastq.gz", cuda, "full")
    launches = {"dense_pass": dense_pass.launches}
    batches = math.ceil(READS / BATCH)
    k_lines = kraken.splitlines()
    n_c = sum(1 for ln in k_lines if ln.startswith(b"C\t"))
    n_cls = classified_reads(csv)
    if len(run_s) != 1:
        raise RuntimeError(f"the CLI called Matcher.run {len(run_s)} times")
    match_s = run_s[0]
    res = {"phase": "match", "reads": READS, "batches": batches,
           "wall_s": secs, "reads_per_s_wall": READS / secs,
           "match_s": match_s, "reads_per_s_match": READS / match_s,
           "launches": launches, "kraken_lines": len(k_lines),
           "classified": n_c, "csv_classified": n_cls,
           "expected_classified": world["hits"]}
    emit(res)
    if launches["dense_pass"] < batches:
        raise RuntimeError(f"dense_pass launched {launches['dense_pass']} "
                           f"times for {batches} batches")
    if len(k_lines) != READS or n_c != world["hits"] or n_cls != world["hits"]:
        raise RuntimeError(f"match output is wrong: {res}")
    return res


def phase_parity(world: dict) -> None:
    t_gpu, csv_g, kr_g, _ = run_cli(world, "parity.fastq.gz",
                                    torch.device("cuda"), "parity_cuda")
    t_cpu, csv_c, kr_c, _ = run_cli(world, "parity.fastq.gz",
                                    torch.device("cpu"), "parity_cpu")
    equal = csv_g == csv_c and kr_g == kr_c
    res = {"phase": "parity", "reads": PARITY_READS, "equal": equal,
           "csv_bytes": len(csv_g), "kraken_bytes": len(kr_g),
           "classified": classified_reads(csv_g),
           "expected_classified": world["parity_hits"],
           "cuda_s": round(t_gpu, 3), "cpu_s": round(t_cpu, 3)}
    emit(res)
    if not equal or res["classified"] != world["parity_hits"]:
        raise RuntimeError(f"CUDA and CPU outputs differ: {res}")


def main() -> None:
    t0 = time.time()
    env = phase_env()
    phase_build()
    kernels = phase_kernels()
    world = phase_world()
    match = phase_match(world)
    phase_parity(world)
    summary = []
    for name, source, replaces in KERNELS:
        k = kernels[world["nb_bits"]]       # the main path's shape
        summary.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": match["launches"][name],
                        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"]})
    emit({"total_s": round(time.time() - t0, 3)})
    emit({"kernels": summary})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                 "count": env["count"]}})


if __name__ == "__main__":
    main()
