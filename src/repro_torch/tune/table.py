"""Versioned tuned-block tables: persisted autotuner winners per site.

The counterpart of ``repro.tune.table``, with its key format
(``kind|site|op|impl|dims|packed``) and its JSON file (version 1, written
byte for byte as the reference writes it). A table maps ``(device_kind,
site, op, impl, shape, packing)`` keys to what the autotuner measured as
fastest there: the spike-matmul tile (stored as ``(block_m, block_k,
block_c)``, the tile's rows, output columns and contraction chunk) and, at
trailing-LIF sites, the fused-vs-pipeline arm. Kernel dispatch consults
the active table: explicit policy overrides still pick the *impl*; a
tuned entry only chooses the tile or arm of whatever impl the policy
resolved, and an unknown key keeps the kernels' own rule, logged once at
INFO.

Impl names in keys are the port's (``cuda+spike_mm``, ``cuda_packed``,
``fused_epilogue``) and the device kind is the card's name with spaces as
dashes (``NVIDIA-H100-80GB-HBM3``), or ``cpu`` for the plain versions' CPU
timings, so the two packages' keys never collide.

The active table is ``$REPRO_TORCH_TUNED_BLOCKS`` if set, else
``benchmarks/torch/tuned_blocks.json`` when that file exists, else none.
It is loaded once per process; call :func:`reload` after writing a new one.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import logging
import os
import pathlib

import torch

logger = logging.getLogger(__name__)

TABLE_VERSION = 1
ENV_VAR = "REPRO_TORCH_TUNED_BLOCKS"
#: The arms an entry of a trailing-LIF site may name.
ARMS = ("fused", "pipeline")
#: Repo-default table location (only consulted when the file exists).
DEFAULT_PATH = pathlib.Path(__file__).resolve().parents[3] / "benchmarks" \
    / "torch" / "tuned_blocks.json"

@dataclasses.dataclass(frozen=True)
class TunedBlocks:
    """One table entry: the winning blocks (None = kernel default) plus the
    provenance the describe and bench layers render."""

    block_m: int | None = None
    block_k: int | None = None
    block_c: int | None = None
    arm: str | None = None            # trailing-LIF sites: fused | pipeline
    oracle_cycles: float | None = None
    measured_us: float | None = None
    sparsity: float | None = None

    def mm_blocks(self) -> tuple[int, int, int] | None:
        """(block_m, block_k, block_c) for the spike-matmul family ops."""
        if None in (self.block_m, self.block_k, self.block_c):
            return None
        return (self.block_m, self.block_k, self.block_c)

    def tile(self) -> int:
        """The spike matmul's ``tile`` argument this entry names: 1 Large,
        2 Small, 0 (the entry point's own rule) when it names no blocks.
        Blocks that are no tile of the kernel raise."""
        blocks = self.mm_blocks()
        if blocks is None:
            return 0
        from repro_torch.kernels.spike_matmul import TILES

        for code, tile in TILES.items():
            if blocks == tile.blocks:
                return code
        raise ValueError(f"tuned blocks {blocks} are no tile of the spike "
                         f"matmul kernel "
                         f"({ {t.name: t.blocks for t in TILES.values()} })")


def current_device_kind(device: str | torch.device | None = None) -> str:
    """Key component: the device the timings were taken on, the card's
    name with spaces as dashes (``torch.cuda.get_device_name``), or the
    device type off the card (``cpu``: the plain versions' timings, which
    never leak onto a card's keys). ``None``: the current CUDA device where
    there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    return _cuda_kind(dev.index if dev.index is not None
                      else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _cuda_kind(index: int) -> str:
    return torch.cuda.get_device_name(index).replace(" ", "-")


def site_key(site: str, op: str, impl: str, shape: tuple[int, ...],
             packed: bool, device_kind: str | None = None) -> str:
    kind = device_kind if device_kind is not None else current_device_kind()
    dims = "x".join(str(int(d)) for d in shape)
    return "|".join([kind, site, op, impl, dims,
                     "packed" if packed else "dense"])


def parse_key(key: str) -> tuple[str, str, str, str, tuple[int, ...], bool]:
    """Inverse of :func:`site_key`; raises ValueError on malformed keys."""
    parts = key.split("|")
    if len(parts) != 6:
        raise ValueError(f"tuned-block key needs 6 '|' fields, got {key!r}")
    kind, site, op, impl, dims, pack = parts
    if pack not in ("packed", "dense"):
        raise ValueError(f"packing field must be packed|dense, got {pack!r}")
    shape = tuple(int(d) for d in dims.split("x") if d)
    return kind, site, op, impl, shape, pack == "packed"


# ---------------------------------------------------------------------------
# Load / save / process-wide cache
# ---------------------------------------------------------------------------

_FIELDS = tuple(f.name for f in dataclasses.fields(TunedBlocks))
_CACHE: dict[str, TunedBlocks] | None = None
_MISS_LOGGED: set[str] = set()


def table_path() -> pathlib.Path | None:
    env = os.environ.get(ENV_VAR)
    if env:
        return pathlib.Path(env)
    return DEFAULT_PATH if DEFAULT_PATH.exists() else None


def load_table(path: str | os.PathLike) -> dict[str, TunedBlocks]:
    """Parse one table file. Unsupported versions load as empty (warned):
    an old table degrades to the kernels' own rules."""
    raw = json.loads(pathlib.Path(path).read_text())
    version = raw.get("version")
    if version != TABLE_VERSION:
        logger.warning("tuned-block table %s has version %r (supported: %d);"
                       " ignoring it", path, version, TABLE_VERSION)
        return {}
    out = {}
    for key, entry in raw.get("entries", {}).items():
        out[key] = TunedBlocks(**{k: v for k, v in entry.items()
                                  if k in _FIELDS})
    return out


def save_table(path: str | os.PathLike, entries: dict[str, TunedBlocks],
               *, meta: dict | None = None) -> None:
    doc = {"version": TABLE_VERSION, **(meta or {})}
    doc["entries"] = {
        key: {k: v for k, v in dataclasses.asdict(tb).items()
              if v is not None}
        for key, tb in sorted(entries.items())}
    pathlib.Path(path).write_text(json.dumps(doc, indent=1, sort_keys=True)
                                  + "\n")


def active_table() -> dict[str, TunedBlocks]:
    global _CACHE
    if _CACHE is None:
        path = table_path()
        try:
            _CACHE = load_table(path) if path is not None else {}
        except (OSError, ValueError, TypeError, json.JSONDecodeError) as e:
            logger.warning("could not load tuned-block table %s: %s; "
                           "the kernels' own rules stay in effect", path, e)
            _CACHE = {}
        if _CACHE:
            logger.info("tuned-block table active: %s (%d entries)",
                        path, len(_CACHE))
    return _CACHE


def reload() -> None:
    """Drop the process-wide cache (tests, or after writing a new table)."""
    global _CACHE
    _CACHE = None
    _MISS_LOGGED.clear()


def lookup(site: str, op: str, impl: str, shape: tuple[int, ...],
           packed: bool, device: str | torch.device | None = None
           ) -> TunedBlocks | None:
    """Dispatch-time lookup for a call on ``device`` (the tensors'). None =
    no table / no entry -> the kernels' own rules (a miss is logged once
    per key at INFO when a table is active). Without a table this is one
    test of a cached empty dict."""
    table = active_table()
    if not table:
        return None
    key = site_key(site, op, impl, shape, packed,
                   current_device_kind(device))
    hit = table.get(key)
    if hit is None and key not in _MISS_LOGGED:
        _MISS_LOGGED.add(key)
        logger.info("no tuned blocks for %s; kernel defaults in effect", key)
    return hit


def lookup_tile(site: str, op: str, impl: str, shape: tuple[int, ...],
                device: str | torch.device | None = None) -> int:
    """The spike matmul's ``tile`` argument for a packed call at ``site``:
    the active table's entry (:meth:`TunedBlocks.tile`), or 0 (the
    kernel's own rule) without one."""
    tb = lookup(site, op, impl, shape, True, device)
    return tb.tile() if tb is not None else 0


# ---------------------------------------------------------------------------
# Rendering (describe_execution appends this next to the dispatch table)
# ---------------------------------------------------------------------------

def describe_tuned(sites: list[str] | None = None,
                   device: str | torch.device | None = None) -> str:
    """CSV block of the active table's entries for ``device``'s kind,
    filtered to ``sites`` when given."""
    path = table_path()
    table = active_table()
    kind = current_device_kind(device)
    rows = []
    for key in sorted(table):
        try:
            dkind, site, op, impl, shape, packed = parse_key(key)
        except ValueError:
            continue
        if dkind != kind or (sites is not None and site not in sites):
            continue
        tb = table[key]
        rows.append(
            f"{site},{op},{impl},{'x'.join(map(str, shape))},"
            f"{'packed' if packed else 'dense'},"
            f"{tb.block_m if tb.block_m is not None else '-'},"
            f"{tb.block_k if tb.block_k is not None else '-'},"
            f"{tb.block_c if tb.block_c is not None else '-'},"
            f"{tb.arm or '-'}")
    head = f"# TunedBlocks device={kind} source={path if table else 'none'}"
    if not rows:
        return head + "\n(no tuned entries; kernel defaults in effect)"
    return "\n".join([head,
                      "site,op,impl,shape,packing,block_m,block_k,block_c,"
                      "arm", *rows])
