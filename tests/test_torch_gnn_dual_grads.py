"""Gradients of the torch port's dual trunk
(``models.nets.gnn_transposed_apply_dual`` through ``ops.gnn_trunk.GNNTrunkDual``)
against the JAX package's ``gnn_transposed_apply_dual`` with
``gnn_impl="pallas_fused"``, whose Pallas kernels run in interpret mode on
the CPU, for each critic aggregation.

Values at rtol 1e-5 / atol 1e-6 and both parameter trees' gradients at
1e-4 max|jax| + 1e-5 per leaf, tanh (the bars of
``tests/test_models.py:609-613``).  The interpreted backward grows with E^2
and depth (at E = 6 and the default depth one JAX gradient takes over 20
minutes on the CPU), so these cases run at E = 3 with no extra EmbedConv or
conv layers; ``tests/test_torch_gnn_dual.py`` holds the values at the full
depth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contracts_marl_aam_corridors_tpu.models.nets import (
    gnn_transposed_apply_dual as jax_apply_dual,
)

from contracts_marl_aam_corridors_tpu_torch.models.convert import state_dict_from_flax
from contracts_marl_aam_corridors_tpu_torch.models.nets import gnn_transposed_apply_dual
from test_torch_gnn_dual import (
    VALUE_TOL,
    assert_grad_close,
    configs,
    flax_tree,
    inputs,
    port_gnn,
)

torch.set_num_threads(1)

AGGRS = ("mean", "max", "add")


@pytest.fixture(scope="module")
def grad_case():
    """Inputs, weights and the JAX values and gradients of the gradient
    cases, for every critic aggregation at once: the interpreted kernels
    cost their compile, and one jit of the three gradients compiles faster
    than three eager calls."""
    jcfg, tcfg = configs(relu=False, embed_layer_n=0, gnn_layer_n=0)
    node_obs, adj, aid = inputs(3, 64, seed=4)
    ta, tc = flax_tree(tcfg, 2), flax_tree(tcfg, 3)

    def jloss(trees, critic_aggr):
        na, nc = jax_apply_dual(jcfg, trees[0], trees[1], jnp.asarray(node_obs),
                                jnp.asarray(adj), jnp.asarray(aid), critic_aggr)
        return jnp.sum(na ** 2) + jnp.sum(nc ** 3), (na, nc)

    all_grads = jax.jit(lambda trees: {
        aggr: jax.value_and_grad(jloss, has_aux=True)(trees, aggr) for aggr in AGGRS})
    return tcfg, (node_obs, adj, aid), (ta, tc), all_grads((ta, tc))


@pytest.mark.parametrize("critic_aggr", AGGRS)
def test_dual_values_and_grads_match_jax(critic_aggr, grad_case):
    """Values and both parameter trees' gradients of
    ``sum(nbd_a^2) + sum(nbd_c^3)`` (the loss of tests/test_models.py:628),
    tanh, E = 3, no extra layers, B = 64 with graph 0 edgeless."""
    tcfg, (node_obs, adj, aid), (ta, tc), jax_out = grad_case
    (_, (want_a, want_c)), jgrads = jax_out[critic_aggr]
    ga, gc = port_gnn(tcfg, ta, "node"), port_gnn(tcfg, tc, "global")
    got_a, got_c = gnn_transposed_apply_dual(
        tcfg, ga, gc, torch.tensor(node_obs), torch.tensor(adj), torch.tensor(aid),
        critic_aggr)
    np.testing.assert_allclose(got_a.detach().numpy(), np.asarray(want_a), **VALUE_TOL)
    np.testing.assert_allclose(got_c.detach().numpy(), np.asarray(want_c), **VALUE_TOL)
    loss = (got_a ** 2).sum() + (got_c ** 3).sum()
    params = list(ga.named_parameters()) + list(gc.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in params])
    want = [state_dict_from_flax(jax.tree.map(np.asarray, g)) for g in jgrads]
    n_a = len(list(ga.parameters()))
    for i, ((name, _), g) in enumerate(zip(params, grads)):
        side = 0 if i < n_a else 1
        assert_grad_close(g.numpy(), want[side][name].numpy(), f"{'ac'[side]}:{name}")
    assert sum(len(w) for w in want) == len(params)
