"""The plain references against the program at tiny sizes on the CPU, and
the check's verdict on sound and broken runs.

The whole of a run but the look for a card (``harness.run_cell`` on the
CPU, the program in float32 through its plain versions): a sound run
agrees with the reference to rounding on every number; a step that leaves
its state unchanged and a step that leaves out half of the batch (the mean
over the rest) come out not correct.
"""

import numpy as np
import pytest
import torch

from tethys_bench import harness
from tethys_bench.reference import common
from tethys_bench.tests import tiny

torch.set_num_threads(2)
SEED = 2 ** 33 + 7          # above 32 bits, as a run's seed may be


def quiet(*args, **kwargs):
    pass


def _run(family, fault=None, seed=SEED, **overrides):
    cell = tiny.cell(family, **overrides)
    return harness.run_cell(cell, seed, 0.2, False, "cpu", 0.0,
                            fault=fault, log=quiet)


@pytest.mark.parametrize("family", ["whisper", "wav2vec2"])
def test_sound_run_agrees_with_reference(family):
    result = _run(family)
    assert result["correct"], result["checked"]
    for name, item in result["checked"].items():
        assert item["value"] <= tiny.TIGHT[name] / 10, (name, item)
    assert result["failed"] == 0 and result["attempted"] >= 3
    assert set(result["metrics"]) == {m["name"] for m in tiny.END_TO_END}


@pytest.mark.parametrize("family,overrides", [
    ("whisper", {"dropout": 0.1, "attention_dropout": 0.1,
                 "activation_dropout": 0.1}),
    ("wav2vec2", {"do_stable_layer_norm": True, "activation_dropout": 0.1}),
])
def test_other_paths_agree_with_reference(family, overrides):
    """The reference's paths that the cells' configurations do not take
    (Whisper's dropout sites, Wav2Vec2's pre-LN layers) agree too."""
    result = _run(family, **overrides)
    assert result["correct"], result["checked"]
    for name, item in result["checked"].items():
        assert item["value"] <= tiny.TIGHT[name] / 10, (name, item)
    assert result["failed"] == 0 and result["attempted"] >= 3
    assert set(result["metrics"]) == {m["name"] for m in tiny.END_TO_END}


@pytest.mark.parametrize("family", ["whisper", "wav2vec2"])
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_broken_step_is_not_correct(family, fault):
    result = _run(family, fault)
    assert not result["correct"], result["checked"]


@pytest.mark.parametrize("offset,shape", [(0, (3, 5, 7)), (6, (2, 9)),
                                          (1027, (4, 33))])
def test_keep_mask_equals_the_programs(offset, shape):
    """The reference's Philox bits of a block at any offset are the
    program's bits of those elements of the whole tensor."""
    from tethys_tpu_torch.ops import dropout as port_dropout

    n = int(np.prod(shape))
    whole = port_dropout.keep_mask(123456789, (offset + n,), 0.1)
    block = common.keep_mask(123456789, shape, 0.1, offset)
    assert torch.equal(block.reshape(-1), whole[offset:])


def test_step_generator_equals_the_programs():
    from tethys_tpu_torch.parallel import dp

    for seed, step in ((0, 0), (SEED, 2), (2 ** 31 + 5, 7)):
        a = common.step_generator(seed, step)
        b = dp.step_generator(seed, step)
        assert torch.equal(torch.randint(0, 2 ** 31 - 1, (16,), generator=a),
                           torch.randint(0, 2 ** 31 - 1, (16,), generator=b))
