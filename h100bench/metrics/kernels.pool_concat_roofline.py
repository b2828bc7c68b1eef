"""K8's pools and concats at their roofline: the least time the bytes of
one step's pools and concats take at the peak bandwidth (pool_concat.py's
count; peaks.json, by the device's name) over K8's device time a traced
step. Bytes bound this work: it does no multiply-add.

The reader's RunInfo carries neither the cell nor the device, so it takes
the configuration and the traffic from the single cell that this metric's
own entry in BENCHMARK.json lists, and the device's name from torch. It
reads nothing when that entry lists more or fewer than one cell, without a
peak for the device, and where the stretch ran no K8. A `benchmark` PR must
hand the cell to the readers before this metric is listed in any other
cell."""

from h100bench import manifest, pool_concat, reference

NAME = "kernels.pool_concat_roofline"


def _device_kind():
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else None


def read(run, kind=None, bench=None):
    st = run.stretch
    if st is None or not any(pool_concat.is_k8(a.name) for a in st.activities):
        return None
    bench = bench or manifest.benchmark()
    cells = [w for m in bench["per_layer"] if m["name"] == NAME for w in m.get("workloads", [])]
    peaks = manifest.load_json(manifest.HERE / "peaks.json").get(kind or _device_kind())
    if len(cells) != 1 or not peaks:
        return None
    c = manifest.cell(bench, cells[0])
    cfg = c["config"]
    layers = reference.build(cfg["reference"]["family"], **cfg["reference"]["kwargs"])
    floor_s = pool_concat.step_bytes(layers, (c["traffic"]["batch"], *cfg["input_shape"])) \
        / peaks["hbm_bytes_per_s"]
    return 100.0 * floor_s / (pool_concat.device_us(st) / 1e6 / st.steps)
