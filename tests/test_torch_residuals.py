"""``repro_torch.core.spikingformer.lif_residual_accounting`` against the
reference's: equal dicts for every preset at ``time_chunk`` None, 1 and 2,
at batch 1 and 16."""
import pytest

from repro.configs.spikingformer import \
    get_spikingformer_config as jax_get_config
from repro.core.spikingformer import \
    lif_residual_accounting as jax_accounting
from repro_torch.configs import get_spikingformer_config, \
    list_spikingformer_configs
from repro_torch.core.spikingformer import lif_residual_accounting

PRESETS = list_spikingformer_configs()


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("time_chunk", [None, 1, 2])
@pytest.mark.parametrize("preset", PRESETS)
def test_accounting_equals_the_references(preset, time_chunk, batch):
    got = lif_residual_accounting(
        get_spikingformer_config(preset, time_chunk=time_chunk), batch)
    want = jax_accounting(
        jax_get_config(preset, time_chunk=time_chunk), batch)
    assert got == want
    assert set(got) == {"elems_per_step", "single_shot_bytes",
                        "tiled_bytes"}
    assert all(type(v) is int for v in got.values())


def test_tiling_saves_where_the_chunk_divides_the_time_steps():
    cfg = get_spikingformer_config("spikingformer-8-512", time_chunk=1)
    acct = lif_residual_accounting(cfg, 16)
    t = cfg.time_steps
    assert acct["tiled_bytes"] == (2 * t + 3) * acct["elems_per_step"] * 4
    assert acct["tiled_bytes"] < acct["single_shot_bytes"] == \
        3 * t * acct["elems_per_step"] * 4
