"""The CPU dry run of ``chip_smoke.py``'s phase 35 (the deep models).

``phase_deep_models`` runs through a torch proxy whose ``torch.device``
is the CPU and whose ``torch.cuda`` syncs and memory reads do nothing, at
cut sizes (ResNet-50 at 64 x 64 on 8 images, narrow pipeline and MoE
layers, two training steps at batch 8). Both of each comparison's sides
then run on the CPU, so the phase's checks must hold with no gap; the test
catches name errors and broken checks before a chip call.
"""

import torch

from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.ops import hopper_histogram as hh
from mmlspark_tpu_torch.ops import u_histogram as uh


class _Cuda:
    """``torch.cuda`` for the dry run."""

    def synchronize(self, *a):
        pass

    def empty_cache(self):
        pass

    def reset_peak_memory_stats(self, *a):
        pass

    def max_memory_allocated(self, *a):
        return 0


class _Torch:
    """``torch`` with every device the CPU and ``cuda`` the stub above."""

    cuda = _Cuda()

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def device(*a, **kw):
        return torch.device("cpu")


def test_chip_smoke_deep_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    import chip_smoke

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    for name, value in (("DATA_DIR", str(tmp_path)), ("N_DEEP", 8),
                        ("DEEP_SHAPES", ((40, 48), (36, 60))), ("DEEP_HW", 64),
                        ("DEEP_BATCH", 4), ("N_DEEP_CPU", 4), ("N_DEEP_ZOO", 4),
                        ("N_DEEP_IMPORT", 8), ("DEEP_WIDTH", 32), ("N_DEEP_PIPE", 64),
                        ("N_DEEP_MOE", 256), ("N_DEEP_TRAIN", 32), ("DEEP_TRAIN_STEPS", 2),
                        ("DEEP_TRAIN_BATCH", 8), ("N_DEEP_TRAIN_CPU", 16)):
        monkeypatch.setattr(chip_smoke, name, value)
    try:
        rec = chip_smoke.phase_deep_models(_Torch(), uh, hh, Table,
                                           "NVIDIA H100 80GB HBM3, 700.00 W")
    finally:
        torch.set_num_threads(threads)
    feat = rec["featurize"]
    assert feat["features_shape"] == [8, 2048] and feat["cut2_shape"] == [4, 2048, 2, 2]
    assert feat["cpu_max_rel_err"] == 0.0 and feat["conv_calls_per_batch"] == 53
    assert rec["zoo"]["all_rows_bit_equal"]
    assert max(rec["imports"]["from_torch_max_rel_err"],
               rec["imports"]["from_onnx_max_rel_err"]) <= chip_smoke.DEEP_IMPORT_TOL
    assert rec["parallel"]["a2a_same_drops"] and rec["parallel"]["max_rel_err"]["a2a"] == 0.0
    train = rec["train"]
    assert train["cpu_trajectory_gap"] == 0.0 and train["cpu_loss_max_rel_err"] == 0.0
    assert train["first_loss_rel_err"] == 0.0
    assert set(rec["parts_s"]) == {"a", "b", "c", "d", "e"}
    assert not (tmp_path / "zoo").exists()
