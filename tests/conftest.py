"""Test configuration: run on the JAX CPU backend with 8 virtual devices.

CPU is the deterministic "fake backend" for GPU-less CI (SURVEY.md §4) and
the 8 virtual devices let the shard_map tests exercise real multi-device
meshes without hardware.  The program runs on the GPU through
``python chip_smoke.py``.

Backends are still uninitialized at conftest time, so ``jax.config`` wins
even where JAX's default platform is a GPU.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


# ---------------------------------------------------------------------------
# smoke / slow tiers: `pytest -m smoke` is the <5 min CI tier; the full
# suite is ~15 min.  Regenerate after big suite changes with
#   python -m pytest tests/ -q --durations=80
# and move tests >= ~7 s here.  Unlisted (new) tests default to smoke.
# ---------------------------------------------------------------------------

_SLOW = {
    "test_extensions.py::test_two_stage_update_extension_matches_fresh_engine",
    "test_graft_entry.py::test_dryrun_multichip_8",
    "test_parallel.py::test_sharded_two_stage_update_reset_clone",
    "test_stream_paths.py::test_stream_khat_exact_and_coherent",
    "test_golden.py::test_two_stage_matches_recorded_golden",
    "test_api_farm.py::test_reverb_farm_varying_call_lengths",
    "test_api_farm.py::test_reverb_farm_long_call",
    "test_fuzz.py::test_two_stage_fuzz[3]",
    "test_parallel.py::test_sharded_two_stage_matches_single_device",
    "test_aliasing.py::test_donated_chained_scan_per_engine",
    "test_stream_paths.py::test_two_stage_tail_khat_conv_core_matches",
    "test_api_farm.py::test_reverb_farm_update_voice_matches_engines",
    "test_fuzz.py::test_two_stage_fuzz[0]",
    "test_parallel.py::test_farm2_bf16_tail_close_to_f32",
    "test_fuzz.py::test_two_stage_fuzz[2]",
    "test_api_farm.py::test_reverb_farm_matches_per_voice_engines",
    "test_parallel.py::test_farm2_sharded_matches_unsharded",
    "test_stream_paths.py::test_two_stage_aligned_matches_scan",
    "test_two_stage.py::test_twostage_equal",
    "test_parallel.py::test_crossfade_wraps_sharded_engine",
    "test_api_farm.py::test_reverb_farm_mesh_shard_map",
    "test_stream_paths.py::test_uniform_batched_stream_state_handoff",
    "test_api_farm.py::test_reverb_farm_on_mesh",
    "test_parallel.py::test_farm_khat_exact",
    "test_api_farm.py::test_reverb_farm_update_voices_subset_and_contracts",
    "test_parallel.py::test_farm2_bf16_update_packed_table",
    "test_parallel.py::test_farm2_bf16_tail_dft_precision",
    "test_parallel.py::test_farm2_stream_sharded_packed",
    "test_stream_paths.py::test_two_stage_wrapper_uses_aligned_path",
    "test_stream_paths.py::test_two_stage_aligned_single_period_and_handoff",
    "test_fuzz.py::test_crossfade_fuzz[0]",
    "test_golden.py::test_uniform_matches_recorded_golden",
    "test_parallel.py::test_vmap_farm_matches_loop",
    "test_parallel.py::test_sharded_farm_matches_unsharded",
    "test_parallel.py::test_farm2_head_khat_parity",
    "test_stream_paths.py::test_stream_corr_phased_matches_sequential",
    "test_api_farm.py::test_reverb_farm_per_call_ceiling",
    "test_golden.py::test_per_block_serving_matches_recorded_golden[two_stage]",
    # 4-7 s band, each covered by a faster smoke sibling in the same area
    "test_fuzz.py::test_uniform_update_fuzz[1]",
    "test_fuzz.py::test_uniform_update_fuzz[2]",
    "test_stream_paths.py::test_stream_corr_rebased_matches_sequential",
    "test_crossfade.py::test_crossfader_blockwise_equals_samplewise",
    "test_parallel.py::test_sharded_update_matches_uniform_mid_stream",
    "test_parallel.py::test_sharded_update_padded_seg_count",
    "test_api_farm.py::test_reverb_farm_update_voice_short_ir_farm",
    "test_parallel.py::test_farm2_update_batched",
    "test_runtime.py::test_streaming_convolver_matches_engine",
    "test_stream_paths.py::test_two_stage_wrapper_long_call_conv_tail",
    "test_api_farm.py::test_reverb_farm_head_dft_precision_bf16",
    "test_api_farm.py::test_reverb_farm_random_update_schedule",
    "test_api_farm.py::test_reverb_farm_update_voice_on_mesh",
    "test_api_farm.py::test_reverb_farm_update_voices_packed_storage",
}


def pytest_collection_modifyitems(config, items):
    import warnings

    import pytest as _pytest

    matched = set()
    for item in items:
        key = f"{item.path.name}::{item.name}"
        if key in _SLOW:
            matched.add(key)
            item.add_marker(_pytest.mark.slow)
        else:
            item.add_marker(_pytest.mark.smoke)
    # a renamed/moved slow test silently falls back into the smoke tier;
    # surface stale _SLOW keys loudly (only when the whole suite was
    # collected — a -k/path-filtered run legitimately misses keys)
    leftovers = _SLOW - matched
    if leftovers and len(items) > len(_SLOW):
        warnings.warn(
            "conftest._SLOW entries matched no collected test (renamed or "
            f"removed? re-tier them): {sorted(leftovers)}",
            stacklevel=1,
        )
