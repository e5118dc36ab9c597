"""The work a batch asks of the card, against counts made by hand."""
import pytest

from perfbench import roofline, spec

YI = roofline.Shape(n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, d_head=128,
                    d_ff=11008, vocab=64000)
DANUBE = roofline.Shape(n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_head=120,
                        d_ff=10240, vocab=32000, window=4096)


def test_yi_matmul_flops_a_token():
    # a layer: q and o 4096 x 4096 each, k and v 4096 x 512 each, the MLP
    # 3 x 4096 x 11008: 173,015,040; 32 layers and the 4096 x 64000 head
    assert roofline.matmul_params(YI) == 32 * 173_015_040 + 262_144_000
    assert roofline.matmul_flops_per_token(YI) == 11_597_250_560


def test_danube_matmul_flops_a_token():
    # a layer: 2 x 3840 x 3840 + 2 x 3840 x 960 + 3 x 3840 x 10240 = 154,828,800
    assert roofline.matmul_flops_per_token(DANUBE) == 2 * (24 * 154_828_800 + 3840 * 32000)


def test_visible_pairs():
    assert 2 * roofline.visible_pairs(4096) == 16_781_312
    assert 16 * roofline.visible_pairs(512) == 2_101_248
    # a window of 4096 masks nothing in rows of 4096
    assert roofline.visible_pairs(4096, 4096) == roofline.visible_pairs(4096)
    # a window of 2: every row but the first sees two keys
    assert roofline.visible_pairs(5, 2) == 1 + 2 * 4


@pytest.mark.parametrize("shape, rows, seq_len, flops, attention", [
    (YI, 2, 4096, 1.038e14, 8.80e12),
    (DANUBE, 2, 4096, 6.91e13, 6.19e12),
    (YI, 16, 512, 9.61e13, 1.10e12),
])
def test_batch_flops(shape, rows, seq_len, flops, attention):
    assert roofline.batch_flops(shape, rows, seq_len) == pytest.approx(flops, rel=1e-3)
    assert roofline.attention_flops(shape, rows, seq_len) == pytest.approx(attention, rel=2e-3)


def test_flash_launch_bound():
    # one layer of Yi over 2 x 4096: 4 * 32 * 128 * 16,781,312 products at
    # 989 TFLOP/s (the bytes, 2 * (2 * 2*32*4096*128 + 2 * 2*4*4096*128),
    # take 45 us at 3.35 TB/s, less)
    flops = 4 * 32 * 128 * 16_781_312
    assert roofline.flash_launch_flops(YI, 2, 4096) == flops
    assert roofline.flash_launch_bound_s(YI, 2, 4096) == pytest.approx(flops / 989e12)
    assert roofline.flash_launch_bytes(YI, 2, 4096) == 2 * (2 * 2 * 32 * 4096 * 128
                                                            + 2 * 2 * 4 * 4096 * 128)


@pytest.mark.parametrize("name, shape", [("yi-6b", YI), ("h2o-danube-3-4b", DANUBE)])
def test_the_config_files_give_these_shapes(name, shape):
    bench = spec.benchmark()
    file = {c["name"]: c["file"] for c in bench["configs"]}[name]
    config = spec.read_json(spec.ROOT / file)
    assert spec.model_module(config).work_shape(config) == shape
