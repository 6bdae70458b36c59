"""Project layout and configuration.

Reference equivalents: GSCommon.java (shared <base>/common dirs),
GSProject.java (per-project directory layout, output-file naming, layered
config loading) and base make/Project.java (properties layering).
"""

from __future__ import annotations

import urllib.parse
from pathlib import Path

from genestrip_tpu_torch.config import Config

CONFIG_PROPERTIES = "config.properties"

# database/provenance property keys (ref: GSProject.java:55-66)
REFSEQ_RELEASE = "refseq.release"
GENESTRIP_VERSION = "genestrip.creationVersion"
GENESTRIP_TITLE = "genestrip.creationTitle"
DB_CREATION_DATE = "dbCreationDate"
DB_MD5 = "dbMD5"

# file types and suffixes (ref: GSProject.GSFileType)
SUFFIXES = {
    "fastq_res": ".fastq", "fastq": ".fastq", "fasta": ".fasta", "csv": ".csv",
    "kraken_out": ".out", "kraken_out_res": ".out", "ser": ".ser", "db": ".zip",
    "filter": ".ser", "log": ".log", "svg": ".svg",
}


def parse_properties(path) -> dict:
    out = {}
    p = Path(path)
    if not p.exists():
        return out
    for line in p.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line or line.startswith("#") or line.startswith("!"):
            continue
        if "=" in line:
            k, _, v = line.partition("=")
        elif ":" in line:
            k, _, v = line.partition(":")
        else:
            continue
        out[k.strip()] = v.strip()
    return out


class Common:
    """Shared directories across projects (ref: GSCommon.java:52-99)."""

    def __init__(self, base_dir):
        self.base_dir = Path(base_dir)

    @property
    def common_dir(self) -> Path:
        return self.base_dir / "common"

    @property
    def refseq_dir(self) -> Path:
        return self.common_dir / "refseq"

    @property
    def genbank_dir(self) -> Path:
        return self.common_dir / "genbank"

    @property
    def fastq_dir(self) -> Path:
        return self.common_dir / "fastq"

    @property
    def fasta_dir(self) -> Path:
        return self.common_dir / "fasta"


class Project:
    """A Genestrip project (ref: GSProject.java)."""

    def __init__(self, common: Common, name: str, overrides: dict | None = None,
                 db_path: str | None = None, csv_dir=None, fastq_res_dir=None):
        self.common = common
        self.name = name
        self.db_path = db_path
        self._csv_dir = Path(csv_dir) if csv_dir else None
        self._fastq_res_dir = Path(fastq_res_dir) if fastq_res_dir else None
        self.additional_properties: dict = {}
        base_props = parse_properties(common.base_dir / CONFIG_PROPERTIES)
        proj_props = parse_properties(self.project_dir / CONFIG_PROPERTIES)
        self.config = Config(overrides or {}, proj_props, base_props)

    # -- directories ---------------------------------------------------------

    @property
    def projects_dir(self) -> Path:
        return self.common.base_dir / "projects"

    @property
    def project_dir(self) -> Path:
        return self.projects_dir / self.name

    @property
    def fasta_dir(self) -> Path:
        return self.project_dir / "fasta"

    @property
    def fastq_dir(self) -> Path:
        return self.project_dir / "fastq"

    @property
    def fastq_res_dir(self) -> Path:
        return self._fastq_res_dir or self.fastq_dir

    @property
    def db_dir(self) -> Path:
        return self.project_dir / "db"

    @property
    def csv_dir(self) -> Path:
        return self._csv_dir or (self.project_dir / "csv")

    @property
    def krakenout_dir(self) -> Path:
        return self.project_dir / "krakenout"

    @property
    def log_dir(self) -> Path:
        return self.project_dir / "log"

    @property
    def genbank_dir(self) -> Path:
        return self.project_dir / "genbank"

    @property
    def taxids_file(self) -> Path:
        return self.project_dir / "taxids.txt"

    @property
    def additional_file(self) -> Path:
        return self.project_dir / "additional.txt"

    @property
    def categories_file(self) -> Path:
        return self.project_dir / "categories.txt"

    def dir_for_type(self, ftype: str) -> Path:
        if ftype == "fastq_res":
            return self.fastq_res_dir
        if ftype == "fastq":
            return self.fastq_dir
        if ftype == "fasta":
            return self.fasta_dir
        if ftype in ("csv", "svg"):
            return self.csv_dir
        if ftype in ("kraken_out", "kraken_out_res"):
            return self.krakenout_dir
        if ftype in ("ser", "db", "filter"):
            return self.db_dir
        if ftype == "log":
            return self.log_dir
        raise ValueError(f"Illegal file type: {ftype}")

    # -- output naming (ref: GSProject.getOutputFile:433-580) ----------------

    def file_base_name(self, file_name: str) -> str:
        base = file_name
        for gz in (".gz", ".gzip"):
            if base.endswith(gz):
                base = base[: -len(gz)]
        for suffix in set(SUFFIXES.values()):
            if base.endswith(suffix):
                base = base[: -len(suffix)]
                break
        return base

    def output_file(self, goal: str | None, ftype: str, key: str | None = None,
                    base_file: str | None = None, gzip: bool = False) -> Path:
        base_name = self.file_base_name(base_file) if base_file else ""
        if base_name.startswith(self.name + "_"):
            base_name = base_name[len(self.name) + 1:]
        if key is not None:
            key = urllib.parse.quote_plus(key)[:256]
        if goal is None:
            infix = key or ""
        else:
            infix = goal if key is None else f"{goal}_{key}"
        if infix:
            base_name = f"{infix}_{base_name}" if base_name else infix
        return self.dir_for_type(ftype) / (
            f"{self.name}_{base_name}{SUFFIXES[ftype]}{'.gz' if gzip else ''}")

    @property
    def db_file(self) -> Path:
        if self.db_path:
            return Path(self.db_path)
        return self.output_file("db", "db")

    @property
    def temp_db_file(self) -> Path:
        return self.output_file("tempdb", "db")

    @property
    def db_info_file(self) -> Path:
        return self.output_file("dbinfo", "csv")

    @property
    def temp_db_info_file(self) -> Path:
        return self.output_file("tempdbinfo", "csv")

    @property
    def index_file(self) -> Path:
        return self.output_file("index", "filter", gzip=True)

    # -- input resolution (ref: GSProject.fastaFileFromPath etc.) ------------

    def fasta_file_from_path(self, path: str) -> Path | None:
        for cand in (Path(path), self.fasta_dir / path, self.common.fasta_dir / path):
            if cand.exists():
                return cand
        return None

    def fastq_file_from_path(self, path: str) -> Path | None:
        for cand in (Path(path), self.fastq_dir / path, self.common.fastq_dir / path):
            if cand.exists():
                return cand
        return None

    # -- config shortcuts ----------------------------------------------------

    def __getitem__(self, key):
        return self.config.get(key)

    def all_properties(self) -> dict:
        """Project + config state stamped into the database
        (ref: GSProject.getAllAsProperties)."""
        out = {k: _prop_str(v) for k, v in self.config.as_dict().items()}
        out.update(self.additional_properties)
        return out


def _prop_str(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, list):
        return ",".join(str(x) for x in v)
    return str(v)
