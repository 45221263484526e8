"""chip_smoke.py's phases at tiny sizes on the CPU (the full sizes run on
the GPU), and its refusal to run without a GPU."""

import numpy as np
import pytest

import chip_smoke


def test_main_exits_without_gpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)


def test_require_gpu_names_missing_gpu():
    import jax

    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(jax.devices())
    assert "no GPU" in str(e.value.code)


def test_natural_data_is_seeded():
    a = chip_smoke.natural(2, 16, 12, 3, seed=5)
    assert a.shape == (2, 16, 12, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, chip_smoke.natural(2, 16, 12, 3, seed=5))
    assert not np.array_equal(a[0], a[1])
    assert chip_smoke.scene_u16(8, 8, 2, 1).dtype == np.uint16
    assert chip_smoke.wide_u64(1, 8, 8, 1).dtype == np.uint64


def test_phase_golden():
    chip_smoke.phase_golden(0)


def test_phase_tiles():
    chip_smoke.phase_tiles(0, n=3, h=16, w=16, c=3, samples=2)


def test_phase_scene():
    chip_smoke.phase_scene(0, h=32, w=16, c=2)


def test_phase_wide():
    chip_smoke.phase_wide(0, n=2, h=16, w=16)


def test_phase_foreign():
    chip_smoke.phase_foreign(0, n=3, h=16, w=16, c=3)


def test_phase_four_cards():
    # four of the eight virtual CPU devices (conftest.py)
    chip_smoke.phase_four_cards(0, h=32, w=32, c=3, h64=16, w64=16,
                                ntiles=4, th=16, tw=16)


def test_phase_failure_is_fatal(monkeypatch):
    from qb3_tpu import native

    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(chip_smoke.SmokeFailure, match="native walk"):
        chip_smoke.phase_foreign(0, n=1, h=8, w=8, c=1)
