"""Row-oriented parquet records + per-column writer properties
(counterpart of examples/parquet_records.py).

The parquet/src/record/ API surface (RowIter / typed getters /
to_json_value) over a file written with per-column compression and
encoding overrides (file/properties.rs set_column_* roles).

    python examples_torch/parquet_records.py [--device cuda|cpu]
        [--tmpdir DIR]
"""

import argparse
import json
import tempfile

import arrow_tpu_torch as att
from arrow_tpu_torch.config import resolve_device
from arrow_tpu_torch.io.parquet_io import WriterProperties, write_parquet
from arrow_tpu_torch.io.records import RowIter


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tmpdir", default=tempfile.gettempdir())
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    t = att.Table.from_pydict({
        "id": [1, 2, 3],
        "name": ["anna", None, "carol"],
        "score": [9.5, 7.25, None],
        "tags": att.column([["a", "b"], [], None],
                           att.dtypes.list_(att.utf8), device=dev),
    }, device=dev)
    path = f"{args.tmpdir}/records_example.parquet"
    write_parquet(path, t, WriterProperties(
        compression="snappy",
        column_properties={"name": {"dictionary_enabled": False},
                           "score": {"encoding": "byte_stream_split"}}))

    rows = list(RowIter.from_file(path, device=dev))
    assert rows[0].get_long(0) == 1
    assert rows[0].get_string(1) == "anna"
    assert rows[1].get_string(1) is None
    assert rows[0].get_list(3).elements == ["a", "b"]
    print(json.dumps([r.to_json_value() for r in rows], indent=None))


if __name__ == "__main__":
    main()
