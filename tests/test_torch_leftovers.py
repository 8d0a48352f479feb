"""The JAX package's leftovers in the port, on the CPU: ``ImagePool``
against the JAX pool (the same swaps from the same seed), and the
Logger's ``error`` and ``add_scalars``."""

import logging
import sys

import numpy as np
import torch

from rdfc_gan_torch.utils import Logger
from rdfc_gan_torch.utils.image_pool import ImagePool

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)


def test_image_pool_swaps_as_jax():
    """Five queries of 3 images into pools of 4: the port returns what the
    JAX pool returns, query by query, and keeps the same history."""
    from rdfc_gan_tpu.utils.image_pool import ImagePool as JaxImagePool

    r = np.random.RandomState(0)
    jpool, tpool = JaxImagePool(4, seed=7), ImagePool(4, seed=7)
    swapped = 0
    for _ in range(5):
        batch = r.normal(size=(3, 1, 4, 5)).astype(np.float32)
        want = jpool.query(batch)
        got = tpool.query(torch.from_numpy(batch))
        assert isinstance(got, torch.Tensor) and got.shape == batch.shape
        np.testing.assert_array_equal(got.numpy(), want)
        swapped += int(not np.array_equal(want, batch))
    assert swapped > 0  # the pool did hand back earlier images
    for a, b in zip(tpool.images, jpool.images):
        np.testing.assert_array_equal(a.numpy(), b)


def test_image_pool_size_zero_is_identity():
    x = torch.randn((3, 2, 4, 4))
    assert ImagePool(0).query(x) is x


def test_logger_error_writes_to_file(tmp_path):
    log = Logger(str(tmp_path), name="rdfc_gan_torch.test_error",
                 filename="t.log")
    log.log("an info line")
    log.error("a bad thing")
    log.close()
    lines = (tmp_path / "t.log").read_text().splitlines()
    assert any(" INFO an info line" in ln for ln in lines)
    assert any(" ERROR a bad thing" in ln for ln in lines)


def test_logger_off_main_rank_keeps_only_errors(monkeypatch, capsys):
    """Another rank writes no file and prints errors alone, as the JAX
    Logger's ERROR level off process 0."""
    from rdfc_gan_torch.utils import logger as logger_mod

    monkeypatch.setattr(logger_mod, "is_main", lambda: False)
    log = Logger(None, name="rdfc_gan_torch.test_rank")
    log.log("info from rank 1")
    log.error("error from rank 1")
    log.add_scalars({"loss": 1.0}, 0)
    assert log.tb is False
    log.close()
    err = capsys.readouterr().err
    assert "error from rank 1" in err and "info from rank 1" not in err
    assert all(not isinstance(h, logging.FileHandler)
               for h in logging.getLogger("rdfc_gan_torch.test_rank")
               .handlers)


def test_add_scalars_without_tensorboard_is_a_no_op(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    log = Logger(str(tmp_path), name="rdfc_gan_torch.test_tb_off")
    log.add_scalars({"loss_G": 0.5, "loss_D": 1.5}, step=3)
    assert log.tb is False
    log.close()
    assert not (tmp_path / "tf_logs").exists()


def test_add_scalars_writes_each_stat(monkeypatch, tmp_path):
    """Through ``SummaryWriter`` (a recording stand-in here: importing the
    real one loads TensorFlow where it is installed), ``{prefix}/{name}``
    at the step, into ``work_dir/tf_logs``."""
    import types

    calls = []

    class Writer:
        def __init__(self, log_dir):
            calls.append(("open", log_dir))

        def add_scalar(self, tag, value, step):
            calls.append((tag, value, step))

        def close(self):
            calls.append(("close",))

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Writer))
    log = Logger(str(tmp_path), name="rdfc_gan_torch.test_tb_on")
    log.add_scalars({"loss_G": 0.5}, step=3)
    log.add_scalars({"rmse": 0.25}, step=4, prefix="val")
    log.close()
    assert calls == [("open", str(tmp_path / "tf_logs")),
                     ("train/loss_G", 0.5, 3), ("val/rmse", 0.25, 4),
                     ("close",)]
