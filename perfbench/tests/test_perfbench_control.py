"""The control (the plain reference one precision below the
configuration's: fp8 products for bf16) comes out not correct under
each cell's limits, at a size a test holds.  On the card it runs at the
cells' own sizes: ``control.py --control``."""
import pytest
import torch

from perfbench import control, harness
from perfbench.tests import smoke


def _small(cell):
    wl = harness.workload(cell)
    over = smoke.TRAIN if wl["loop"] == "train" else smoke.PREFILL
    return dict(wl, params={**wl["params"], **over}), \
        smoke.small_config(wl["config"])


@pytest.mark.parametrize("cell", ["smollm-360m.train", "jamba2-mini.prefill",
                                  "smollm-360m.train-dp4"])
def test_control_is_not_correct(cell):
    wl, cfg = _small(cell)
    fn = (control.control_train if wl["loop"] == "train"
          else control.control_prefill)
    nums = fn(wl, cfg, 2 ** 40 + 17, torch.device("cpu"))
    failed = [k for k, lim in wl["limits"].items() if not nums[k] <= lim]
    assert failed, (nums, wl["limits"])
