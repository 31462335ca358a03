"""Checkpoint / resume: device tables <-> IPC files (SURVEY.md §5: the
reference's persistence formats ARE its checkpoint story — the IPC file
format's footer gives random access; this module is the engine's
HBM -> host snapshot path using the same wire format).

checkpoint_table / restore_table round-trip a single table;
CheckpointManager writes versioned step directories with a MANIFEST and
prunes old steps (the orbax-style step layout, IPC payload).
(Counterpart of arrow_tpu/io/checkpoint.py: a checkpoint copies each
buffer to the host once, through the IPC writer; a restore names the
`device` its tables are built on.)
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, List, Optional

from ..config import DeviceLike, resolve_device
from ..core.table import Table
from ..errors import ArrowInvalid

__all__ = ["checkpoint_table", "restore_table", "CheckpointManager"]


def checkpoint_table(path, table: Table,
                     compression: Optional[str] = "zstd") -> None:
    """One table -> one IPC file (zero-copy mmap-able on restore,
    the FileDecoder role, arrow-ipc/src/reader.rs:836)."""
    from .ipc import write_file
    write_file(path, [table], compression=compression)


def restore_table(path, *, device: DeviceLike) -> Table:
    """The table of one checkpoint file, on `device`."""
    from .ipc import read_file
    tables = read_file(path, resolve_device(device))
    if not tables:
        raise ArrowInvalid(f"empty checkpoint {path}")
    if len(tables) == 1:
        return tables[0]
    from ..ops.concat import concat_tables
    return concat_tables(tables)


class CheckpointManager:
    """Versioned step checkpoints of a dict of named tables.

        mgr = CheckpointManager(dir, max_to_keep=3)
        mgr.save(step, {"orders": t1, "dims": t2})
        tables = mgr.restore(device="cuda")          # latest step
        tables = mgr.restore(step=7, device="cuda")
    """

    _MANIFEST = "MANIFEST.json"

    def __init__(self, directory: str, max_to_keep: int = 3,
                 compression: Optional[str] = "zstd"):
        self.directory = str(directory)
        self.max_to_keep = max_to_keep
        self.compression = compression
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name[5:].isdigit():
                manifest = os.path.join(self.directory, name,
                                        self._MANIFEST)
                if os.path.exists(manifest):     # only committed steps
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tables: Dict[str, Table]) -> str:
        """Write all tables, then commit atomically by writing the
        manifest LAST (a crash mid-save leaves an uncommitted dir that
        restore ignores)."""
        d = self._step_dir(step)
        # tmp name must NOT match steps()'s "step_" prefix scan: a crash
        # after the manifest lands in tmp but before the rename would
        # otherwise make int(name[5:]) raise forever
        tmp = os.path.join(self.directory, f".tmp_step_{step:012d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        entries = {}
        for name, t in tables.items():
            fn = f"{name}.arrow"
            checkpoint_table(os.path.join(tmp, fn), t,
                             compression=self.compression)
            entries[name] = {"file": fn, "rows": t.num_rows}
        manifest = {"step": step, "created": time.time(),
                    "tables": entries}
        with open(os.path.join(tmp, self._MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        self._prune()
        return d

    def restore(self, step: Optional[int] = None, *,
                device: DeviceLike) -> Dict[str, Table]:
        """The tables of `step` (default the latest) on `device`."""
        resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise ArrowInvalid(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, self._MANIFEST)) as f:
            manifest = json.load(f)
        return {name: restore_table(os.path.join(d, e["file"]), device=device)
                for name, e in manifest["tables"].items()}

    def _prune(self):
        steps = self.steps()
        for s in steps[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
