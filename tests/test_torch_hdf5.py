"""The port's HDF5 reader (``rdfc_gan_torch/data/hdf5.py``) against
``h5py``, which this sandbox has and the card's machine lacks: files
``h5py`` writes by default, contiguous and gzip-chunked (edge chunks past
the extent), uint8, uint16, f32, f64 and big-endian, in nested groups, read
equal; ``h5py`` reads the port's writer's files (and the s2d fixture's)
back equal; what the reader does not take raises ``ValueError`` naming the
file."""

import os

import numpy as np
import pytest
import torch

from rdfc_gan_torch.data import hdf5

h5py = pytest.importorskip("h5py")

# Tier-1 runs several pytest workers on the machine's cores: one intra-op
# thread per worker.
torch.set_num_threads(1)


def _arrays(seed):
    r = np.random.RandomState(seed)
    return {"u8": r.randint(0, 256, (3, 48, 64)).astype(np.uint8),
            "u16": r.randint(0, 65536, (37, 51)).astype(np.uint16),
            "f32": r.uniform(0, 9, (48, 64)).astype(np.float32),
            "f64": r.normal(size=(5, 7)),
            "i16be": r.randint(-3000, 3000, (4, 9)).astype(">i2"),
            "f32be": r.normal(size=(6, 5)).astype(">f4")}


def _all_datasets(path):
    names = []
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: names.append(n)
                     if isinstance(o, h5py.Dataset) else None)
        return {n: f[n][:] for n in names}


def _same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("layout", ["contiguous", "gzip", "chunked"])
def test_reads_what_h5py_writes(tmp_path, layout):
    """Every dataset, in the root group and in nested groups; the chunk
    shapes leave edge chunks on every axis, and the many names make the
    group B-tree hold several symbol-table nodes."""
    p = str(tmp_path / "h.h5")
    arrays = _arrays(1)
    with h5py.File(p, "w") as f:
        for i, (k, a) in enumerate(arrays.items()):
            parent = f if i % 2 == 0 else f.require_group(f"g{i}/sub")
            kw = {}
            if layout != "contiguous":
                kw = dict(chunks=tuple(max(1, d // 3 + 1) for d in a.shape))
                if layout == "gzip":
                    kw.update(compression="gzip", compression_opts=1 + i)
            parent.create_dataset(k, data=a, **kw)
        for i in range(20):
            f[f"many{i:02d}"] = np.full((3,), i, np.int32)
    want = _all_datasets(p)
    assert len(want) == len(arrays) + 20
    with hdf5.File(p) as f:
        for name, a in want.items():
            _same(f[name][:], a, name)
        with pytest.raises(KeyError):
            f["missing"]


def test_h5py_reads_the_writers_files(tmp_path):
    p = str(tmp_path / "w.h5")
    arrays = _arrays(2)
    hdf5.write_contiguous(p, arrays)
    got = _all_datasets(p)
    assert set(got) == set(arrays)
    for k, a in arrays.items():
        _same(got[k], a, k)
        with hdf5.File(p) as f:
            _same(f[k][:], a, k)


def test_h5py_reads_the_s2d_fixture(tmp_path):
    from rdfc_gan_torch.tools.make_s2d_fixture import write_fixture

    written = write_fixture(str(tmp_path), n_train=1, n_val=1, seed=3)
    assert sorted(written) == ["train/00000.h5", "val/00000.h5"]
    for fn, arrays in written.items():
        got = _all_datasets(str(tmp_path / fn))
        _same(got["rgb"], arrays["rgb"], fn)
        _same(got["depth"], arrays["depth"], fn)
        assert got["rgb"].shape == (3, 480, 640)
        assert (got["depth"] == 0).any() and (got["depth"] > 0.5).any()


@pytest.mark.parametrize("case", ["latest", "shuffle", "lzf", "fletcher32",
                                  "string", "vlen", "compact", "scaleoffset"])
def test_what_it_does_not_take_raises(tmp_path, case):
    p = str(tmp_path / f"{case}.h5")
    data = np.arange(100.0).reshape(10, 10)
    kw = dict(chunks=(5, 5))
    with h5py.File(p, "w", **({"libver": "latest"}
                              if case == "latest" else {})) as f:
        if case == "latest":
            f["x"] = data
        elif case in ("shuffle", "fletcher32"):
            f.create_dataset("x", data=data, **kw, **{case: True})
        elif case == "lzf":
            f.create_dataset("x", data=data, compression="lzf", **kw)
        elif case == "scaleoffset":
            f.create_dataset("x", data=data, scaleoffset=2, **kw)
        elif case == "string":
            f["x"] = np.array([b"abc", b"de"])
        elif case == "vlen":
            f["x"] = "hello"
        else:
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            f.create_dataset("x", data=np.arange(4), dcpl=dcpl)
    with pytest.raises(ValueError, match=os.path.basename(p)):
        hdf5.File(p)["x"][:]


def test_not_hdf5_raises(tmp_path):
    p = tmp_path / "x.h5"
    p.write_bytes(b"not an hdf5 file" * 64)
    with pytest.raises(ValueError, match="no HDF5 signature"):
        hdf5.File(str(p))
