"""Training of the recurrent, SSD, encoder-decoder and VLM families on
meshes over gloo ranks, in float32, against the reference's
``jax.value_and_grad(forward_train)`` on the same meshes.

RecurrentGemma (RG-LRU with its channels over the model axis, the
ring-window attention), Mamba-2 (the SSD replicated over the model
axis, its projections gathered), SeamlessM4T (the encoder on the
frames, cross-attention over its output) and Llama-3.2-Vision
(cross-attention over a seeded memory) smoke configurations on (2,1)
and (1,2): the loss, every metric and every leaf's gradient, gathered to
global, within 1e-4 relative of the reference's; one AdamW update's
``grad_norm``, ``lr`` and moments too (see ``tests/torch_mesh_train.py``).
"""
from __future__ import annotations

import pytest

import torch_mesh_train as T

CONFIGS = {
    # one superblock (RG-LRU, RG-LRU, ring-window attention) and a
    # 2-layer RG-LRU tail
    "recurrentgemma": ("recurrentgemma-2b-smoke", {"num_layers": 5}),
    "mamba2": ("mamba2-130m-smoke", {}),
    "seamless": ("seamless-m4t-medium-smoke", {}),
    "vision": ("llama-3.2-vision-11b-smoke", {}),
}
MESHES_OF = {name: ["2x1", "1x2"] for name in CONFIGS}
#: the 2-rank meshes as 2 replicas
WORLD = 4


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return T.run(tmp_path_factory, "test_torch_sharded_train_mixers")


@pytest.mark.parametrize("name,mesh", [(n, m) for n in CONFIGS
                                       for m in MESHES_OF[n]])
def test_loss_and_gradients_match_reference_on_mesh(both, name, mesh):
    want, got = both
    T.check_case(want, got, f"{name}/{mesh}")
