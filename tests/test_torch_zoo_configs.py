"""The port's model-zoo configs (``repro_torch.configs``) against the JAX
package's: every registered architecture, its full config and its
``reduced()`` smoke variant field for field, the derived properties, the
registry's lookups and the input shapes."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro import configs as jc  # noqa: E402
from repro_torch import configs as tc  # noqa: E402

ARCHS = jc.list_archs()
DERIVED = ("hd", "padded_vocab", "n_periods", "tail", "is_encdec")


def _fields(cfg):
    return dataclasses.asdict(cfg) | {k: getattr(cfg, k) for k in DERIVED} | {
        "kind_counts": cfg.kind_counts()}


def test_registry_lists_the_same_architectures():
    assert tc.list_archs() == ARCHS
    assert len(ARCHS) == 11
    with pytest.raises(KeyError, match="unknown arch"):
        tc.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ["full", "reduced"])
def test_config_field_for_field(arch, variant):
    ref, port = jc.get_config(arch), tc.get_config(arch)
    if variant == "reduced":
        ref, port = ref.reduced(), port.reduced()
    assert _fields(port) == _fields(ref)
    port.validate()


def test_reduced_overrides_and_validation():
    ref = jc.get_config("qwen3-8b").reduced(sliding_window=4, pattern=("local_attn",) * 2)
    port = tc.get_config("qwen3-8b").reduced(sliding_window=4, pattern=("local_attn",) * 2)
    assert _fields(port) == _fields(ref)
    bad = dataclasses.replace(tc.get_config("qwen3-8b"), n_kv_heads=5)
    with pytest.raises(AssertionError):
        bad.validate()


def test_qwen3_8b_full_width():
    cfg = tc.get_config("qwen3-8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff) == (
        36, 4096, 32, 8, 128, 12288)
    assert (cfg.vocab_size, cfg.padded_vocab, cfg.rope_theta, cfg.qk_norm) == (
        151936, 152064, 1e6, True)


def test_input_shapes():
    assert {k: dataclasses.asdict(v) for k, v in tc.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jc.INPUT_SHAPES.items()}
