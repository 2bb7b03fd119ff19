"""The partition of a mask into regions on the CPU (``ops/components.py``):
``partition_labels``' region stats, compaction and ordering, run on CPU
tensors over the plain labels, against the native flood
(``flood_partition``); the labelling's wrapper, which takes the plain version
for a CPU tensor; and the routing by where a mask lies: host masks to the
native flood, tensors to the labelling where they lie. Kernel 10 itself runs
only on the card (``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from satellite_approximation_tpu_torch import native
from satellite_approximation_tpu_torch.models.detection import cloud_mask as cm
from satellite_approximation_tpu_torch.ops import components as C
from satellite_approximation_tpu_torch.ops import stencil_kernels as K
from satellite_approximation_tpu_torch.utils import profiling
from torch_parity import COMPONENT_KINDS, COMPONENT_SHAPES, component_mask

SHAPE_IDS = ["x".join(map(str, s)) for s in COMPONENT_SHAPES]


def flood(m, min_area):
    """The native flood's (id map, regions)."""
    assert native.available(), "the native library (g++) is needed for the reference"
    id_map, count = native.flood_partition(m, min_area)
    return id_map, C._regions_from_labels(id_map, count)


@pytest.mark.parametrize("min_area", [1, 3])
@pytest.mark.parametrize("kind", COMPONENT_KINDS)
@pytest.mark.parametrize("shape", COMPONENT_SHAPES, ids=SHAPE_IDS)
def test_partition_labels_equals_flood(shape, kind, min_area):
    m = component_mask(*shape, kind)
    labels = C.label_components(torch.from_numpy(m))
    id_map, regions = C.partition_labels(labels, min_area)
    want_map, want_regions = flood(m, min_area)
    assert id_map.dtype == torch.int32 and id_map.device.type == "cpu"
    assert np.array_equal(id_map.numpy(), want_map)
    assert regions == want_regions


@pytest.mark.parametrize("kind", COMPONENT_KINDS)
def test_region_stats_by_rank(kind):
    """The six numbers of each region, by rank, against a direct reading of
    the plain labels: the roots in flat order, their pixels' extents and
    the least scan key col * H + (H - 1 - row)."""
    h, w = 37, 53
    m = component_mask(h, w, kind)
    plain = C.connected_components(torch.from_numpy(m)).numpy()
    labels = torch.from_numpy(plain.copy())
    count = C._rank_roots(labels)
    roots = np.flatnonzero(plain.ravel() == np.arange(h * w))
    assert count == len(roots)
    assert np.array_equal(labels.view(-1)[roots].numpy(), -1 - np.arange(count))
    stats = C.region_stats(labels, count).numpy()
    rows, cols = np.indices((h, w))
    for rank, root in enumerate(roots):
        sel = plain == root
        want = [sel.sum(), rows[sel].min(), rows[sel].max(), cols[sel].min(), cols[sel].max(),
                (cols[sel] * h + (h - 1 - rows[sel])).min()]
        assert stats[:, rank].tolist() == want


@pytest.mark.parametrize("connectivity", [4, 8])
def test_label_components_takes_the_plain_version_on_the_cpu(connectivity, monkeypatch):
    m = torch.from_numpy(component_mask(37, 53, "random-0.6"))
    before = dict(K.launch_counts)
    got = C.label_components(m, connectivity)
    assert torch.equal(got, C.connected_components(m, connectivity))
    assert K.launch_counts == before
    with pytest.raises(ValueError):
        C.label_components(m, 6)
    with pytest.raises(TypeError):
        C.label_components(m.to(torch.uint8))


def boxes(clouds):
    return [(c.id, c.region, c.min_x, c.max_x, c.min_y, c.max_y) for c in clouds]


@pytest.mark.parametrize("shape", [(37, 53), (257, 131)], ids=["37x53", "257x131"])
def test_partition_cloud_mask_on_a_tensor_equals_the_host_route(shape):
    m = component_mask(*shape, "random-0.3")
    want_map, want_clouds = cm.partition_cloud_mask(m, 10.0, 3)
    got_map, got_clouds = cm.partition_cloud_mask(torch.from_numpy(m), 10.0, 3)
    assert isinstance(want_map, np.ndarray)
    assert isinstance(got_map, torch.Tensor) and got_map.dtype == torch.int32
    assert np.array_equal(got_map.numpy(), want_map) and boxes(got_clouds) == boxes(want_clouds)
    for got, want in zip(got_clouds, want_clouds):
        assert np.array_equal(got.quad.corners(), want.quad.corners())
    assert len(want_clouds) > 3


def _recorder(monkeypatch, module, name):
    seen = []
    real = getattr(module, name)

    def recording(*args, **kwargs):
        seen.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, recording)
    return seen


@pytest.mark.parametrize("entry", ["partition_regions", "partition_cloud_mask"])
def test_host_masks_take_the_native_flood(entry, monkeypatch):
    floods = _recorder(monkeypatch, native, "flood_partition")
    labelled = _recorder(monkeypatch, C, "label_components")
    m = component_mask(40, 50, "random-0.6")
    if entry == "partition_regions":
        id_map, _ = C.partition_regions(m, 3)
    else:
        id_map, _ = cm.partition_cloud_mask(m, 10.0, 3)
    assert len(floods) == 1 and labelled == [] and isinstance(id_map, np.ndarray)


@pytest.mark.parametrize("entry", ["partition_regions", "partition_cloud_mask"])
def test_cpu_tensors_take_the_plain_propagation(entry, monkeypatch):
    floods = _recorder(monkeypatch, native, "flood_partition")
    plain = _recorder(monkeypatch, C, "connected_components")
    m = torch.from_numpy(component_mask(40, 50, "random-0.6"))
    before = dict(K.launch_counts)
    if entry == "partition_regions":
        id_map, _ = C.partition_regions(m, 3)
        assert isinstance(id_map, np.ndarray)
    else:
        id_map, _ = cm.partition_cloud_mask(m, 10.0, 3)
        assert isinstance(id_map, torch.Tensor) and id_map.device.type == "cpu"
    assert floods == [] and [t.device.type for t in plain] == ["cpu"]
    assert K.launch_counts == before


@pytest.mark.parametrize("on", ["host", "tensor"])
def test_partition_counts_regions_and_route(on):
    """Under a profile, the partition's span counts the clouds kept and
    ``on_device`` 0 off the card."""
    m = component_mask(40, 50, "random-0.3")
    mask = m if on == "host" else torch.from_numpy(m)
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("detect.cloud partition"):
                _, clouds = cm.partition_cloud_mask(mask, 10.0, 3)
        (rec,) = [r for r in profiling.records() if r.name == "detect.cloud partition"]
    finally:
        profiling.clear()
    assert rec.counts == {"regions": len(clouds), "on_device": 0} and len(clouds) > 3
