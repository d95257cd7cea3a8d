"""chip_smoke.py's training cells, on the CPU: the cut each full-width
cell trains at, the disk its checkpoints take, which architectures train
and which do not (and why), the stub-carrying cell's batches, the launch
counts its kernel entries take by mask, and the digest that holds a
replayed step to the bits of the first run."""
import pathlib
import sys

import pytest
import torch

from repro_torch.configs.base import get_arch, list_archs
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

# the cells this file pins: (depth, ArchConfig.param_count()) at full width
CELLS = {
    "qwen3-0.6b": (28, 596_042_752),
    "gemma3-4b": (6, 1_237_352_960),
    "granite-20b": (1, 983_058_432),
    "starcoder2-3b": (1, 397_943_808),
    "llava-next-34b": (1, 1_475_367_936),
}


@pytest.mark.parametrize("arch", CELLS)
def test_train_config_cuts_each_new_cell_to_its_depth(arch):
    cfg = cs.train_config(arch)
    full = get_arch(arch)
    depth, n_params = CELLS[arch]
    assert cfg.n_layers == depth == sum(len(p) * r for p, r in cfg.block_groups)
    assert cfg.param_count() == n_params
    # only the depth is cut: the widths, vocabulary and masks stay the card's
    for field in ("d_model", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab_size", "window",
                  "n_patches", "ffn_gated", "qk_norm", "tie_embeddings"):
        assert getattr(cfg, field) == getattr(full, field), field


def test_gemma3_cell_is_its_unit_and_qwen3_trains_at_full_depth():
    gemma = cs.train_config("gemma3-4b")
    assert list(gemma.layer_kinds()) == ["local"] * 5 + ["global"]
    assert cs.train_config("qwen3-0.6b").n_layers == get_arch("qwen3-0.6b").n_layers
    assert cs.train_config(cs.ENCDEC_ARCH) == get_arch(cs.ENCDEC_ARCH)  # full depth


@pytest.mark.parametrize("arch", CELLS)
def test_each_new_cell_fits_the_disk_budget(arch):
    """The trainer's cells write at steps 2 and 4 around a crash before step
    4 and keep two checkpoints; the stub cell saves once."""
    ckpt = 12 * CELLS[arch][1]
    if arch in cs.STUB_TRAIN_ARCHS:
        writes = [cs.STUB_SAVE_STEP]
    else:
        writes = cs.checkpoint_writes(cs.TRAIN["total_steps"], cs.TRAIN["ckpt_every_steps"],
                                      cs.TRAIN_FAULT_STEP)
        assert writes == [2, 4]
    need = cs.disk_need(ckpt, writes)
    assert need == min(len(writes), 3) * ckpt <= cs.DISK_BUDGET


def test_every_architecture_trains_or_says_why_not():
    trained = set(cs.TRAIN_ARCHS) | set(cs.STUB_TRAIN_ARCHS)
    assert not trained & set(cs.NOT_TRAINED)
    assert trained | set(cs.NOT_TRAINED) == set(list_archs())
    assert not cs.NOT_TRAINED  # llama4-scout-17b-a16e trains under the 8-bit state
    assert all(isinstance(why, str) and why for why in cs.NOT_TRAINED.values())
    assert set(CELLS) <= trained
    assert set(cs.TRAIN_REF_SEQ) == trained


def test_llama4_scout_cannot_train_at_one_layer():
    """Under the f32 AdamW state, why its cell takes the 8-bit one
    (chip_smoke.OPT8BIT_ARCHS): one full-width layer's f32 masters, moments
    and gradients (16 bytes a parameter) and bf16 weights (2) leave under
    4 GB of the 80 GB card, and one checkpoint (12 bytes) exceeds
    DISK_BUDGET."""
    cfg = get_arch("llama4-scout-17b-a16e")
    one = cfg.replace(n_layers=1, block_groups=((("chunked",), 1),))
    n = one.param_count()
    assert 4.27e9 < n < 4.28e9
    assert 80e9 - 18 * n < 4e9 and 12 * n > cs.DISK_BUDGET


def test_model_phase_trains_every_architecture():
    assert set(cs.MODEL_TRAIN_ARCHS) == set(list_archs())


@pytest.mark.parametrize("arch,stub,n", [("llava-next-34b", "patches", 576),
                                         ("seamless-m4t-large-v2", "frames", 1024)])
def test_stub_cell_batch(arch, stub, n):
    """llava-next-34b's rows are 576 patches in front of 1472 tokens (2048
    positions, as its serve prefill has them); seamless-m4t-large-v2's
    rows are 2048 tokens over 1024 frames.  Each step draws its own stubs,
    the same for the same step."""
    cfg = cs.train_config(arch)
    B, S = cs.TRAIN["global_batch"], cs.TRAIN["seq_len"]
    text = cs.text_len(cfg, S)
    assert text == (1472 if stub == "patches" else 2048)
    pipe = SyntheticLMPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=text,
                                          global_batch=B, seed=cs.TRAIN["seed"]))
    batch = cs.stub_cell_batch(cfg, pipe, 0, "cpu")
    assert set(batch) == {"tokens", stub}
    assert batch["tokens"].shape == (B, text + 1) and batch["tokens"].dtype == torch.long
    assert batch[stub].shape == (B, n, cfg.d_model) and batch[stub].dtype == torch.float32
    assert float(batch[stub].std()) == pytest.approx(cs.STUB_STD, rel=0.05)
    again, later = cs.stub_cell_batch(cfg, pipe, 0, "cpu"), cs.stub_cell_batch(cfg, pipe, 1, "cpu")
    assert torch.equal(again[stub], batch[stub]) and torch.equal(again["tokens"], batch["tokens"])
    assert not torch.equal(later[stub], batch[stub])
    if stub == "patches":
        assert n + text == S


def _entries(models, dtype):
    return {f"flash_attention_{w}/{m}/{dtype}": {"launches": None}
            for m in models for w in ("fwd_lse", "bwd")}


def test_train_entries_take_the_launches_at_their_own_mask():
    """gemma3-4b's local and global entries count apart; an entry without a
    sub-key takes every launch of its wrapper; seamless-m4t-large-v2's
    encoder, decoder and cross-attention by mask and Sq != Sk; the other
    dtype's entries and other models' stay as they are."""
    gemma = cs.train_config("gemma3-4b")
    state = {"kernels": {**_entries(["gemma3-4b/local", "gemma3-4b/global", "rsc-llm"],
                                    "bfloat16"),
                         **_entries(["gemma3-4b/local"], "float32")}}
    masks = {("fwd_lse", True, 1024, 0, False): 20, ("bwd", True, 1024, 0, False): 10,
             ("fwd_lse", True, 0, 0, False): 4, ("bwd", True, 0, 0, False): 2}
    cs.train_entry_launches(state, "gemma3-4b", gemma, "bfloat16", "a path", masks)
    got = {k: v["launches"] for k, v in state["kernels"].items()}
    assert got == {"flash_attention_fwd_lse/gemma3-4b/local/bfloat16": 20,
                   "flash_attention_bwd/gemma3-4b/local/bfloat16": 10,
                   "flash_attention_fwd_lse/gemma3-4b/global/bfloat16": 4,
                   "flash_attention_bwd/gemma3-4b/global/bfloat16": 2,
                   "flash_attention_fwd_lse/rsc-llm/bfloat16": None,
                   "flash_attention_bwd/rsc-llm/bfloat16": None,
                   "flash_attention_fwd_lse/gemma3-4b/local/float32": None,
                   "flash_attention_bwd/gemma3-4b/local/float32": None}
    cs.train_entry_launches(state, "rsc-llm", cs.train_config("rsc-llm"), "bfloat16", "p",
                            {("bwd", True, 0, 0, False): 3, ("bwd", True, 7, 0, False): 1})
    assert state["kernels"]["flash_attention_bwd/rsc-llm/bfloat16"]["launches"] == 4
    assert state["kernels"]["flash_attention_fwd_lse/rsc-llm/bfloat16"]["launches"] == 0
    seamless = cs.train_config(cs.ENCDEC_ARCH)
    parts = ("encoder", "decoder", "cross")
    state = {"kernels": _entries([f"{cs.ENCDEC_ARCH}/{p}" for p in parts], "bfloat16")}
    cs.train_entry_launches(state, cs.ENCDEC_ARCH, seamless, "bfloat16", "p", {
        ("bwd", False, 0, 0, False): 96, ("bwd", True, 0, 0, False): 97,
        ("bwd", False, 0, 0, True): 98})
    assert [state["kernels"][f"flash_attention_bwd/{cs.ENCDEC_ARCH}/{p}/bfloat16"]["launches"]
            for p in parts] == [96, 97, 98]


def test_bits_digest_tells_a_changed_bit_and_a_swap():
    """Equal bits give equal digests; one flipped bit (here the lowest of
    one f32 word) changes its leaf's digest, as does swapping two words."""
    g = torch.Generator().manual_seed(0)
    tree = ({"w": torch.randn(1000, generator=g), "b": torch.randn(3, 4, generator=g)},
            torch.tensor(3, dtype=torch.int32))
    base = cs.bits_digest(tree)
    assert base == cs.bits_digest((
        {k: v.clone() for k, v in tree[0].items()}, tree[1].clone()))
    assert set(base) == {"0/b", "0/w", "1"}
    flipped = tree[0]["w"].clone()
    flipped.view(torch.int32)[517] ^= 1
    got = cs.bits_digest(({"w": flipped, "b": tree[0]["b"]}, tree[1]))
    assert got["0/w"] != base["0/w"] and got["0/b"] == base["0/b"]
    swapped = tree[0]["w"].clone()
    swapped[[3, 900]] = swapped[[900, 3]]
    assert cs.bits_digest({"w": swapped})["w"] != base["0/w"]
    assert cs.bits_digest({"w": tree[0]["w"].bfloat16()})["w"] != base["0/w"]


def test_closed_form_counts_every_flash_shape_the_script_runs():
    """Every FLASH_TRAIN row, the seven added for the new cells among them,
    is counted by ``kernels.cost`` as its whole mask counts it."""
    for model in ("qwen3-0.6b", "starcoder2-3b", "granite-20b", "gemma3-4b/local",
                  "gemma3-4b/global", "llava-next-34b", "llama4-scout-17b-a16e"):
        B, S, H, KV, D, causal, window, chunk = cs.FLASH_TRAIN[model][:8]
        cfg = get_arch(model.partition("/")[0])
        assert (H, KV, D) == (cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
        assert (B, S) == (cs.TRAIN["global_batch"], cs.TRAIN["seq_len"])
    cs.check_closed_form()
