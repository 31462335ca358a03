"""Cross-implementation golden data via the integration JSON format
(counterpart of examples/integration_json.py).

The arrow-integration-test role: dump a table as the Archery JSON
test-data document, rebuild it on the device, and round-trip through a
native IPC file exactly (the arrow-json-integration-test VALIDATE
mode).

    python examples_torch/integration_json.py [--device cuda|cpu]
        [--tmpdir DIR]
"""

import argparse
import json
import tempfile

import arrow_tpu_torch as att
from arrow_tpu_torch.config import resolve_device
from arrow_tpu_torch.io import integration_json as ij


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tmpdir", default=tempfile.gettempdir())
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    t = att.Table.from_pydict({
        "x": [1, None, 3],
        "s": ["alpha", "beta", None],
        "d": att.compute.dictionary_encode(
            att.column(["hi", "hi", "lo"], device=dev)),
    }, device=dev)
    doc = ij.table_to_json(t)
    print(json.dumps(doc["schema"]["fields"][2]))     # dictionary field

    back = ij.table_from_json(json.loads(json.dumps(doc)), device=dev)
    assert back.to_pydict() == t.to_pydict()

    jp = f"{args.tmpdir}/ij_example.json"
    ap_ = f"{args.tmpdir}/ij_example.arrow"
    ij.write_json_file(jp, t)
    ij.json_to_arrow(jp, ap_)
    assert ij.validate(ap_, jp)
    print("VALIDATE ok")


if __name__ == "__main__":
    main()
