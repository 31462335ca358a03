"""IPC file write + read from a memory map (arrow/examples/
zero_copy_ipc.rs; counterpart of examples/zero_copy_ipc.py): the native
decoder (io/ipc.py) slices column buffers directly out of the mapped
body, and each buffer is copied once, onto the device.

    python examples_torch/zero_copy_ipc.py [--device cuda|cpu]
"""

import argparse
import mmap
import tempfile

import arrow_tpu_torch as att
from arrow_tpu_torch.config import resolve_device
from arrow_tpu_torch.io import ipc
from arrow_tpu_torch.utils.display import pretty_format_table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    t = att.Table.from_pydict({
        "id": list(range(10)),
        "name": [f"row-{i}" for i in range(10)],
    }, device=dev)
    with tempfile.NamedTemporaryFile(suffix=".arrow",
                                     delete=False) as f:
        path = f.name
    ipc.write_file(path, [t, t.slice(0, 5)])

    # memory-map the file; the decoder reads from the mapped region
    with open(path, "rb") as f:
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            batches = ipc.read_file(memoryview(mm), dev)
            print(f"{len(batches)} batches")
            print(pretty_format_table(batches[1]))


if __name__ == "__main__":
    main()
