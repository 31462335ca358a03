"""Command-line tools (the parquet crate's src/bin/ suite + the
flight_sql_client binary, arrow-flight/src/bin/); counterpart of
arrow_tpu/cli.py.

    python -m arrow_tpu_torch.cli parquet-read    file.parquet [--limit N]
    python -m arrow_tpu_torch.cli parquet-schema  file.parquet
    python -m arrow_tpu_torch.cli parquet-rewrite in.parquet out.parquet
                                                  [--compression zstd]
    python -m arrow_tpu_torch.cli parquet-concat  out.parquet in1 in2 ...
    python -m arrow_tpu_torch.cli parquet-fromcsv in.csv out.parquet
    python -m arrow_tpu_torch.cli parquet-layout  file.parquet
    python -m arrow_tpu_torch.cli parquet-index   file.parquet column
    python -m arrow_tpu_torch.cli parquet-show-bloom-filter file.parquet column v1 v2 ...
    python -m arrow_tpu_torch.cli pretty          file.parquet [--limit N]
    python -m arrow_tpu_torch.cli flight-sql      --uri grpc://host:port "SQL"

Every command takes `--device` (default `cuda`): where the tables it
reads or receives are placed; asking for `cuda` with no card raises.
The commands that read only file metadata (parquet-schema,
parquet-layout, parquet-index, parquet-show-bloom-filter) and
json-integration, whose file conversions run on the host, ignore it.
Everything printed equals the reference CLI's output for the same file
or query.
"""

from __future__ import annotations

import argparse
import json
import sys

from .config import resolve_device


def _read_table(path, device):
    from .io.parquet_io import read_parquet
    return read_parquet(path, device=device)


def cmd_parquet_read(args):
    """parquet-read: rows as JSON lines (parquet/src/bin/parquet-read.rs)."""
    t = _read_table(args.file, args.device)
    d = t.to_pydict()
    n = t.num_rows if args.limit is None else min(args.limit, t.num_rows)
    names = t.column_names
    for i in range(n):
        print(json.dumps({k: d[k][i] for k in names}, default=str))


def cmd_parquet_schema(args):
    """parquet-schema: schema + file metadata."""
    from .io.parquet_io import read_metadata
    md = read_metadata(args.file)
    print(f"num_rows: {md.num_rows}")
    print(f"num_row_groups: {md.num_row_groups}")
    print(f"created_by: {md.created_by}")
    print("schema:")
    print(md.schema)


def cmd_parquet_rewrite(args):
    """parquet-rewrite: decode + re-encode with new properties."""
    from .io.parquet_io import write_parquet, WriterProperties
    t = _read_table(args.input, args.device)
    props = WriterProperties(compression=args.compression,
                             encoding=args.encoding,
                             data_page_version=args.page_version,
                             dictionary_enabled=not args.no_dictionary)
    write_parquet(args.output, t, properties=props)
    print(f"rewrote {t.num_rows} rows -> {args.output}")


def cmd_parquet_concat(args):
    """parquet-concat: concatenate row groups of several files."""
    from .io.parquet_io import write_parquet
    from .ops.concat import concat_tables
    tables = [_read_table(p, args.device) for p in args.inputs]
    out = concat_tables(tables)
    write_parquet(args.output, out)
    print(f"concatenated {len(tables)} files, {out.num_rows} rows "
          f"-> {args.output}")


def cmd_parquet_fromcsv(args):
    """parquet-fromcsv: CSV -> Parquet with schema inference."""
    from .io.csv import read_csv
    from .io.parquet_io import write_parquet
    t = read_csv(args.input, device=args.device)
    write_parquet(args.output, t)
    print(f"wrote {t.num_rows} rows -> {args.output}")


def cmd_parquet_layout(args):
    """parquet-layout: physical row-group/page structure
    (parquet/src/bin/parquet-layout.rs role, on the native reader)."""
    from .io.parquet_native import ParquetFile
    pf = ParquetFile(args.file)
    print(json.dumps({"num_rows": pf.num_rows,
                      "row_groups": len(pf.row_groups)}))
    for gi, rg in enumerate(pf.row_groups):
        print(f"row group {gi}: rows={rg.get(3, 0)} "
              f"bytes={rg.get(2, 0)}")
        for ci, chunk in enumerate(rg.get(1, [])):
            md = chunk.get(3, {})
            path = b".".join(md.get(3, [])).decode()
            encs = md.get(2, [])
            print(f"  column {ci} [{path}]: codec={md.get(4, 0)} "
                  f"values={md.get(5, 0)} "
                  f"compressed={md.get(7, 0)}B encodings={encs} "
                  f"dict_page={'yes' if md.get(11) is not None else 'no'} "
                  f"bloom={'yes' if md.get(14) is not None else 'no'}")


def cmd_parquet_index(args):
    """parquet-index: per-row-group column statistics
    (parquet/src/bin/parquet-index.rs role)."""
    from .io.parquet_io import read_metadata
    md = read_metadata(args.file)
    names = [f.name for f in md.schema.fields]
    try:
        col = names.index(args.column)
    except ValueError:
        sys.exit(f"no column {args.column!r} (have {names})")
    for gi in range(md.num_row_groups):
        st = md.column_statistics(gi, col)
        if st is None:
            print(f"row group {gi}: no statistics")
        else:
            print(f"row group {gi}: min={st['min']} max={st['max']} "
                  f"nulls={st['null_count']}")


def cmd_parquet_show_bloom_filter(args):
    """parquet-show-bloom-filter: probe sbbf membership per row group
    (parquet/src/bin/parquet-show-bloom-filter.rs role)."""
    from .io.parquet_native import ParquetFile
    pf = ParquetFile(args.file)
    values = [int(v) if v.lstrip("-").isdigit() else v
              for v in args.values]
    for gi in range(len(pf.row_groups)):
        hit = pf.bloom_filter_check(gi, args.column, values)
        if hit is None:
            print(f"row group {gi}: no bloom filter")
            continue
        for v, h in zip(values, hit):
            print(f"row group {gi}: {v!r} -> "
                  f"{'maybe present' if h else 'absent'}")


def cmd_pretty(args):
    """pretty: ASCII table of a parquet/csv file."""
    path = args.file
    if path.endswith(".csv"):
        from .io.csv import read_csv
        t = read_csv(path, device=args.device)
    else:
        t = _read_table(path, args.device)
    if args.limit is not None and t.num_rows > args.limit:
        t = t.slice(0, args.limit)
    from .utils.display import pretty_format_table
    print(pretty_format_table(t))


def cmd_json_integration(args):
    from .io import integration_json as ij
    if args.mode == "JSON_TO_ARROW":
        ij.json_to_arrow(args.json, args.arrow)
    elif args.mode == "ARROW_TO_JSON":
        ij.arrow_to_json(args.arrow, args.json)
    else:
        ok = ij.validate(args.arrow, args.json)
        if not ok:
            raise SystemExit("VALIDATE failed: arrow != json")
        print("OK")


def cmd_flight_sql(args):
    """flight_sql_client: run one query (or DML with --update) against
    a FlightSQL server (arrow-flight/src/bin/flight_sql_client.rs); the
    answer lands on --device."""
    from .io.flightsql import FlightSQLClient
    from .utils.display import pretty_format_table
    cli = FlightSQLClient(args.uri, device=args.device)
    try:
        verb = args.query.lstrip().split(None, 1)
        is_dml = args.update or (verb and verb[0].lower() in (
            "insert", "update", "delete", "create", "drop"))
        if is_dml:
            n = cli.execute_update(args.query)
            print(f"{n} rows affected")
        else:
            t = cli.execute(args.query)
            print(pretty_format_table(t))
    finally:
        cli.close()


def main(argv=None):
    p = argparse.ArgumentParser(prog="arrow_tpu_torch.cli")
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda",
                     help="where the tables read or received are placed "
                          "(default cuda)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def command(name, fn, metadata_only=False):
        s = sub.add_parser(name, parents=[dev])
        s.set_defaults(fn=fn, metadata_only=metadata_only)
        return s

    s = command("parquet-read", cmd_parquet_read)
    s.add_argument("file")
    s.add_argument("--limit", type=int, default=None)

    s = command("parquet-schema", cmd_parquet_schema, metadata_only=True)
    s.add_argument("file")

    s = command("parquet-rewrite", cmd_parquet_rewrite)
    s.add_argument("input")
    s.add_argument("output")
    s.add_argument("--compression", default="snappy")
    s.add_argument("--encoding", default=None,
                   help="plain|delta_binary_packed|delta_length_byte_"
                        "array|delta_byte_array|byte_stream_split|rle")
    s.add_argument("--page-version", default="1.0",
                   choices=["1.0", "2.0"])
    s.add_argument("--no-dictionary", action="store_true")

    s = command("parquet-concat", cmd_parquet_concat)
    s.add_argument("output")
    s.add_argument("inputs", nargs="+")

    s = command("parquet-fromcsv", cmd_parquet_fromcsv)
    s.add_argument("input")
    s.add_argument("output")

    s = command("parquet-layout", cmd_parquet_layout, metadata_only=True)
    s.add_argument("file")

    s = command("parquet-index", cmd_parquet_index, metadata_only=True)
    s.add_argument("file")
    s.add_argument("column")

    s = command("parquet-show-bloom-filter", cmd_parquet_show_bloom_filter,
                metadata_only=True)
    s.add_argument("file")
    s.add_argument("column")
    s.add_argument("values", nargs="+")

    s = command("pretty", cmd_pretty)
    s.add_argument("file")
    s.add_argument("--limit", type=int, default=20)

    s = command("flight-sql", cmd_flight_sql)
    s.add_argument("--uri", required=True)
    s.add_argument("--update", action="store_true",
                   help="force DoPut CommandStatementUpdate")
    s.add_argument("query")

    # arrow-json-integration-test binary role
    # (arrow-integration-testing/src/bin/arrow-json-integration-test.rs)
    s = command("json-integration", cmd_json_integration,
                metadata_only=True)
    s.add_argument("--mode", choices=["JSON_TO_ARROW", "ARROW_TO_JSON",
                                      "VALIDATE"], required=True)
    s.add_argument("--json", required=True)
    s.add_argument("--arrow", required=True)

    args = p.parse_args(argv)
    if not args.metadata_only:
        args.device = resolve_device(args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
