"""Host orchestration of the batched matcher on one torch device: streams
reads, runs the device step, accumulates statistics, writes filtered fastq /
Kraken-style output.

Port of genestrip_tpu/match/matcher.py::Matcher for a single device. The
host methods (`run`, `_finalize_batch`, `_write_kraken`, `_build_result`,
`_max_kmer_counts`, `_unique_per_node`) are the reference's, minus its
multi-process sharding and merge (not ported yet); `__init__`, `reset`,
`_drain` and `_dispatch_batch` hold torch tensors on the given device. The
chunked long-read path (`_match_long_read`, `matchlr` with classification
off) is not ported yet; with classification on, long reads go through
`_dispatch_batch` as singleton batches, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from genestrip_tpu_torch.io.reads import (
    BatchPacker, ReadBatch, batch_feeder, parse_reads,
)
from genestrip_tpu_torch.io.streams import Progress, ReadAhead, StreamingResource
from genestrip_tpu_torch.match.arrays import match_arrays_from_numpy
from genestrip_tpu_torch.match.pipeline import (
    LABEL_INVALID, LABEL_MISS, MatchConfig, TableSpec, error_bounds,
    match_accum_step, node_state_init, unpack_per_read_np, vaux_from_nov,
)
from genestrip_tpu_torch.match.results import CountsPerTaxid, MatchingResult
from genestrip_tpu_torch.store.hash import build_hash
from genestrip_tpu_torch.store.table import KmerTable
from genestrip_tpu_torch.tax.small import SmallTaxTree


class _HostCopy:
    """A device tensor's copy to the host, started at once, awaited on use.

    On CUDA the copy goes into pinned memory on the current stream right
    after the batch's kernels, so the host can pack and dispatch the next
    batch before this one's results are read; `np.asarray` waits for the
    copy alone, not for work enqueued after it."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
        else:
            self._host, self._done = t, None

    def __array__(self, dtype=None, copy=None):
        if self._done is not None:
            self._done.synchronize()
        a = self._host.numpy()
        return a if dtype is None else a.astype(dtype)


class Matcher:
    """Matches fastq/fasta resources against a database on one device."""

    def __init__(self, table: KmerTable, tree: SmallTaxTree, cfg: MatchConfig,
                 device: torch.device, db_md5: str = "",
                 batch_size: int = 4096, max_kmer_res_counts: int = 0,
                 write_all: bool = True, prebuilt_hash=None):
        """device: the torch device every tensor of the match lives on.
        prebuilt_hash: optional KmerHashTable (e.g. persisted in the db zip,
        store/database.py) — skips the hash build."""
        self.table = table
        self.tree = tree
        self.db_md5 = db_md5
        self.max_kmer_res_counts = max_kmer_res_counts
        self.write_all = write_all
        self.cfg = cfg
        self.device = torch.device(device)
        # progress/throughput logging (ref AbstractLoggingFastqStreamer)
        self.progress = True
        self.progress_interval_ms = 1000
        # ref GSConfigKey withProbs: carry input quality strings through to
        # filtered-fastq output instead of synthesizing '~'
        self.with_probs = False
        # ref GSConfigKey threads: 0 = parse synchronously; otherwise
        # parse/pack runs on a worker thread with a bounded prefetch queue
        # overlapping the device steps (-1 = default on)
        self.threads = -1
        # reads longer than this are cut into singleton batches
        self.long_read_threshold = 10_000
        self.n_nodes = len(tree)
        self.batch_size = batch_size
        ht = (prebuilt_hash if prebuilt_hash is not None
              else build_hash(table.keys, table.value_idx))
        vaux = vaux_from_nov(tree.node_of_value(table).astype(np.int32), tree)
        arrays = match_arrays_from_numpy(ht.rows, vaux, tree.ancestor_at_depth,
                                         self.device)
        self._rows, self._vaux, self._anc = (
            arrays["rows"], arrays["vaux"], arrays["anc"])
        self._spec = TableSpec(ht.n_slots, ht.nb_bits)
        self._vidx_of_slot = ht.vidx_of_slot
        self._n_table = ht.n_slots
        self.reset()

    def reset(self):
        T = self.n_nodes
        N = self._n_table
        self.kmers = np.zeros(T, np.int64)
        self.contigs = np.zeros(T, np.int64)
        self.contig_sq = np.zeros(T, np.int64)
        self.max_contig = np.zeros(T, np.int64)
        self.max_contig_desc = [b""] * T
        # (resource index, read number) key of each node's max-contig
        # achiever, as in the reference
        self.max_contig_src = np.full(T, np.iinfo(np.int64).max, np.int64)
        self._res_idx = 0
        self.reads1 = np.zeros(T, np.int64)
        self.reads = np.zeros(T, np.int64)
        self.reads_kmers = np.zeros(T, np.int64)
        self.reads_bps = np.zeros(T, np.int64)
        self.error_sum = np.zeros(T, np.float64)
        self.error_sq_sum = np.zeros(T, np.float64)
        self.class_error_sum = np.zeros(T, np.float64)
        self.class_error_sq_sum = np.zeros(T, np.float64)
        self.total_reads = 0
        self.total_kmers = 0
        self.total_bps = 0
        dev = self.device
        self._seen = torch.zeros(N + 1, dtype=torch.uint8, device=dev)
        self._counts = torch.zeros(N + 1 if self.cfg.with_counts else 1,
                                   dtype=torch.int32, device=dev)
        # device node-statistic accumulators (drained every few batches; the
        # int32 contig^2 budget decides when) + descriptor ring for resolving
        # max-contig achievers at drain time
        self._nstate = node_state_init(T, dev)
        self._ws_budget = 0
        self._batch_no = 0
        self._ring: dict[int, tuple] = {}

    # ------------------------------------------------------------------
    # device node-accumulator drain

    _WS_CAP = 2**31 - 1

    def _drain(self):
        """Pull + fold the device node accumulators into the host arrays,
        resolve max-contig achiever descriptors from the batch ring, and
        reset the device state (additive parts zeroed; the max-contig trio
        re-seeded from the host so the strict-> fold keeps first-achiever
        semantics across drains)."""
        if not self._ring:
            return          # nothing folded since the last drain
        d = {k: v.cpu().numpy() for k, v in self._nstate.items()}
        self.kmers += d["kmers"].astype(np.int64)
        self.contigs += d["contigs"].astype(np.int64)
        self.contig_sq += d["contig_sq"].astype(np.int64)
        self.reads1 += d["reads1"].astype(np.int64)
        mc_len, mc_enc, mc_bno = d["mc_len"], d["mc_enc"], d["mc_bno"]
        improved = (mc_bno >= 0) & (mc_len.astype(np.int64) > self.max_contig)
        for t in np.nonzero(improved)[0]:
            t = int(t)
            descriptors, read_no0, res_idx, W = self._ring[int(mc_bno[t])]
            b = int(mc_enc[t]) // W
            desc = descriptors[b]
            sp = desc.find(b" ")
            self.max_contig[t] = int(mc_len[t])
            self.max_contig_desc[t] = desc[1:sp if sp >= 0 else len(desc)]
            self.max_contig_src[t] = (res_idx << 40) | (read_no0 + b)
        self._ring.clear()
        self._ws_budget = 0
        # reset device state: zero adds, seed mc_len from host, mark resolved
        seed = node_state_init(self.n_nodes, self.device)
        seed["mc_len"] = torch.from_numpy(
            np.minimum(self.max_contig, 2**31 - 1).astype(np.int32)).to(self.device)
        self._nstate = seed

    # ------------------------------------------------------------------

    def run(self, resources, filtered_out=None, kraken_out=None):
        """Match all resources; returns a MatchingResult.

        filtered_out/kraken_out are writable binary streams or None.

        Host and device overlap by one batch (double buffering): batch N+1 is
        parsed, packed and dispatched before batch N's outputs are pulled back
        and accumulated — CUDA launches are async, so the device runs batch N
        while the host packs N+1 (ref equivalent: the producer/consumer
        overlap of fastq/AbstractFastqReader.java:88-185).
        """
        pending = None

        def all_batches():
            """Tagged (res_idx, progress, batch|None) across the resources;
            None closes a resource's progress. Running this
            on the feeder thread means resource i+1's open + decompress +
            parse overlap resource i's device steps (no inter-file stall;
            ref: the reference keeps its consumer pool busy across files,
            AbstractLoggingFastqStreamer.processFastqStreams:95-140)."""
            for res_idx, res in enumerate(resources):
                if not isinstance(res, StreamingResource):
                    res = StreamingResource(res)
                fasta = res.type_hint == "fasta"
                packer = BatchPacker(self.batch_size,
                                     with_probs=self.with_probs,
                                     long_threshold=self.long_read_threshold)
                progress = Progress(f"match {res.name}", res,
                                    enabled=self.progress,
                                    interval_ms=self.progress_interval_ms)
                with res.open() as stream:
                    src = (ReadAhead(stream) if self.threads != 0
                           else stream)
                    try:
                        for batch in parse_reads(src, packer, fasta):
                            yield res_idx, progress, batch
                    finally:
                        if src is not stream:
                            src.close()   # stop the read-ahead thread
                yield res_idx, progress, None

        gen = all_batches()
        if self.threads != 0:
            gen = batch_feeder(gen, prefetch=4)
        for res_idx, progress, batch in gen:
            if batch is None:
                progress.done()
                continue
            self._res_idx = res_idx
            if batch.is_long and not self.cfg.classify:
                # chunked long-read path (host-merged stats); keep
                # output order by finalizing the pending batch first
                if pending is not None:
                    self._finalize_batch(*pending, filtered_out, kraken_out)
                    pending = None
                self._match_long_read(batch, filtered_out, kraken_out)
                progress.update(1)
                continue
            out = self._dispatch_batch(batch, kraken_out is not None)
            if pending is not None:
                self._finalize_batch(*pending, filtered_out, kraken_out)
            pending = (batch, out)
            progress.update(batch.n)
        if pending is not None:
            self._finalize_batch(*pending, filtered_out, kraken_out)
        return self._build_result()

    def _dispatch_batch(self, batch: ReadBatch, need_labels: bool):
        """Pack + enqueue the accumulating device step; returns the host
        copies (started, not awaited) of the packed per-read words and of
        the labels (or None)."""
        cfg = self.cfg
        need_labels = need_labels or cfg.return_labels
        if need_labels != cfg.return_labels:
            cfg = MatchConfig(**{**cfg.__dict__, "return_labels": need_labels})
        # Pad partial batches to the fixed batch size (zero-length rows are
        # inert), as the reference does.
        n_real = batch.n
        codes, lengths = batch.codes, batch.lengths
        b_target = 1 if batch.is_long else self.batch_size
        if n_real < b_target:
            pad = b_target - n_real
            codes = np.concatenate(
                [codes, np.full((pad, codes.shape[1]), 255, np.uint8)])
            lengths = np.concatenate([lengths, np.zeros(pad, np.int32)])
        B, L = codes.shape
        W = L - cfg.k + 1
        if self._ws_budget + B * W * W > self._WS_CAP:
            self._drain()          # keep the int32 contig^2 accumulator exact
        bounds = error_bounds(lengths, cfg.k, cfg)
        bno = self._batch_no
        dev = self.device
        packed, label, self._seen, self._counts, self._nstate = \
            match_accum_step(cfg, self._spec, self.n_nodes,
                             self._rows, self._vaux, self._anc,
                             torch.from_numpy(codes).to(dev),
                             torch.from_numpy(lengths).to(dev),
                             torch.from_numpy(bounds).to(dev), self._seen,
                             self._counts, self._nstate, bno)
        self._ring[bno] = (batch.descriptors, batch.read_no0,
                           self._res_idx, W)
        self._batch_no = bno + 1
        self._ws_budget += B * W * W
        return (_HostCopy(packed),
                _HostCopy(label) if label is not None else None)

    def _match_long_read(self, batch: ReadBatch, filtered_out, kraken_out):
        raise NotImplementedError(
            "matchlr (long reads with classification off) is not ported to "
            "genestrip_tpu_torch yet: ROADMAP queue 1, item 1")

    def _finalize_batch(self, batch: ReadBatch, out, filtered_out, kraken_out):
        """Unpack ONE packed int32 per-read transfer (see pipeline
        pack_per_read) and accumulate the host-side per-read statistics in
        read order (ref :508-530); per-node statistics stay on device until
        the next drain."""
        cfg = self.cfg
        packed, label = out
        n_real = batch.n
        pk = np.asarray(packed)[:n_real]
        L = batch.codes.shape[1]
        cls, found, stats_ok, tax_err, read_kmers = unpack_per_read_np(
            pk, self.n_nodes, L - cfg.k + 1, L)
        n_win = np.maximum(batch.lengths.astype(np.int64) - (cfg.k - 1), 0)

        # totals (ref: AbstractFastqReader.doReadFastq:343-349)
        self.total_reads += n_real
        self.total_kmers += int(n_win.sum())
        self.total_bps += int(batch.lengths.sum())

        # per-read classified stats, in read order (ref :508-530)
        if cfg.classify:
            ok = stats_ok & (cls >= 0)
            idx = np.nonzero(ok)[0]
            if len(idx):
                nodes = cls[idx]
                nw = n_win[idx].astype(np.float64)
                err = tax_err[idx] / nw
                rk = read_kmers[idx]
                cerr = (n_win[idx] - rk) / nw
                np.add.at(self.reads, nodes, 1)
                np.add.at(self.reads_kmers, nodes, rk)
                np.add.at(self.reads_bps, nodes, batch.lengths[idx].astype(np.int64))
                np.add.at(self.error_sum, nodes, err)
                np.add.at(self.error_sq_sum, nodes, err * err)
                np.add.at(self.class_error_sum, nodes, cerr)
                np.add.at(self.class_error_sq_sum, nodes, cerr * cerr)

        # outputs
        if filtered_out is not None and found.any():
            probs = batch.probs
            for b in np.nonzero(found)[0]:
                filtered_out.write(batch.descriptors[b])
                filtered_out.write(b"\n")
                filtered_out.write(batch.seqs[b])
                filtered_out.write(b"\n+\n")
                if probs is not None and probs[b]:
                    filtered_out.write(probs[b])
                else:
                    filtered_out.write(b"~" * len(batch.seqs[b]))
                filtered_out.write(b"\n")

        if kraken_out is not None:
            self._write_kraken(batch, np.asarray(label)[:n_real], n_win,
                               cls, kraken_out)

    def _write_kraken(self, batch: ReadBatch, labels, n_win, class_node, out):
        """Kraken-style output lines (ref: FastqKMerMatcher.printKrakenStyleOut
        :597-611 + MatcherReadEntry.writeMatchDetails:723-756)."""
        taxids = self.tree.taxids
        for b in range(batch.n):
            W = int(n_win[b])
            if W <= 0:
                continue  # no windows -> no output buffer in the reference
            cn = int(class_node[b])
            if not (self.write_all or cn >= 0):
                continue
            row = labels[b, :W]
            # RLE segments
            bounds = np.nonzero(np.diff(row))[0] + 1
            starts = np.concatenate([[0], bounds])
            ends = np.concatenate([bounds, [W]])
            segs = []
            for s, e in zip(starts, ends):
                v = int(row[s])
                if v == LABEL_INVALID:
                    tag = b"A"
                elif v == LABEL_MISS:
                    tag = b"0"
                else:
                    tag = taxids[v].encode()
                segs.append(tag + b":" + str(e - s).encode())
            desc = batch.descriptors[b]
            sp = desc.find(b" ")
            name = desc[1:sp if sp >= 0 else len(desc)]
            line = (b"C\t" if cn >= 0 else b"U\t") + name + b"\t" + \
                (taxids[cn].encode() if cn >= 0 else b"0") + b"\t" + \
                str(int(batch.lengths[b])).encode() + b"\t" + b" ".join(segs) + b"\n"
            out.write(line)

    # ------------------------------------------------------------------

    def _build_result(self) -> MatchingResult:
        self._drain()
        tree = self.tree
        unique = self._unique_per_node() if self.cfg.with_unique else None
        count_map = (self._max_kmer_counts()
                     if self.cfg.with_counts and self.max_kmer_res_counts > 0
                     else None)
        taxid2stats: dict[str, CountsPerTaxid] = {}
        touched = (self.kmers > 0) | (self.reads > 0) | (self.reads1 > 0)
        for t in np.nonzero(touched)[0]:
            t = int(t)
            s = CountsPerTaxid(int(tree.depth[t]), tree.taxids[t])
            s.reads = int(self.reads[t])
            s.reads1_kmer = int(self.reads1[t])
            s.reads_bps = int(self.reads_bps[t])
            s.reads_kmers = int(self.reads_kmers[t])
            s.kmers = int(self.kmers[t])
            s.contigs = int(self.contigs[t])
            s.contig_len_squared_sum = int(self.contig_sq[t])
            s.max_contig_len = int(self.max_contig[t])
            s.max_contig_descriptor = self.max_contig_desc[t]
            s.error_sum = float(self.error_sum[t])
            s.error_squared_sum = float(self.error_sq_sum[t])
            s.class_error_sum = float(self.class_error_sum[t])
            s.class_error_squared_sum = float(self.class_error_sq_sum[t])
            s.unique_kmers = int(unique[t]) if unique is not None else -1
            if count_map is not None:
                s.max_kmer_counts = count_map.get(tree.taxids[t])
            taxid2stats[tree.taxids[t]] = s
        return MatchingResult(self.cfg.k, taxid2stats, self.db_md5,
                              self.total_reads, self.total_kmers, self.total_bps,
                              total_max_counts=(count_map.get(None)
                                                if count_map is not None else None))

    def _max_kmer_counts(self) -> dict:
        """Top-N per-k-mer match counts per taxid among its matched k-mers,
        plus the overall top-N under the None key (ref:
        KMerUniqueCounterBits.getMaxCountsCounts:172-199). The reference's
        count vector is a short; counts saturate at 32767."""
        N = self.max_kmer_res_counts
        seen = self._seen.cpu().numpy()[:-1] > 0
        counts = np.minimum(self._counts.cpu().numpy()[:-1], 32767)
        sel = np.nonzero(seen)[0]
        out: dict = {None: [0] * N}
        if len(sel) == 0:
            return out
        c = counts[sel].astype(np.int64)
        vi = self._vidx_of_slot[sel]
        keep = vi >= 0
        sel, c, vi = sel[keep], c[keep], vi[keep]
        # per value: top-N counts descending (zero-padded)
        order = np.lexsort((-c, vi))
        vi_s, c_s = vi[order], c[order]
        starts = np.nonzero(np.concatenate([[True], vi_s[1:] != vi_s[:-1]]))[0]
        ends = np.concatenate([starts[1:], [len(vi_s)]])
        for s0, e0 in zip(starts, ends):
            taxid = self.table.values[int(vi_s[s0])]
            top = c_s[s0:min(e0, s0 + N)].tolist()
            out[taxid] = top + [0] * (N - len(top))
        total = np.sort(c)[::-1][:N].tolist()
        out[None] = total + [0] * (N - len(total))
        return out

    def _unique_per_node(self) -> np.ndarray:
        """Unique k-mers per node: segment-sum of the seen bits over the
        table's value indexes (ref: KMerUniqueCounterBits.getUniqueKmerCounts)."""
        seen = self._seen.cpu().numpy()[:-1].astype(np.int64)
        vos = self._vidx_of_slot
        m_ = vos >= 0
        per_value = np.bincount(vos[m_], weights=seen[m_],
                                minlength=self.table.n_values).astype(np.int64)
        out = np.zeros(self.n_nodes, np.int64)
        nov = self.tree.node_of_value(self.table)
        m = nov >= 0
        np.add.at(out, nov[m], per_value[m])
        return out
