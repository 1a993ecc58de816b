"""The port's MC-CNN sharding rules and mesh trainer, on the CPU.

The JAX package shards the tower's conv output channels over a "model"
axis and the batch over "data" (GSPMD on the 8 virtual CPU devices of
``tests/conftest.py``); the port runs the same split in one process over a
("data", "model") device list that repeats ``cpu``. Tolerances:

* the rules and their answers: equal;
* one sharded SGD step from the same flax parameters against JAX's
  sharded step (``tests/test_mccnn.py::test_sharded_train_step``'s
  setting): the loss within STEP_RTOL relative and every parameter within
  STEP_TOL. Measured on torch 2.13's CPU: 7.8e-8 and 6.0e-8, the sums
  running in another order (JAX's own test holds 1e-4 and 1e-5);
* the mesh trainer against the single-device trainer, 3 Adam steps: the
  losses within TRAIN_RTOL relative, the weights' move within MOVE_RTOL of
  the single-device move in norm (each "model" device convolves its own
  output channels and the loss is summed row by row, so the float32 sums
  run in another order; measured 1.9e-7 and 5.2e-7). A learning rate 10 %
  high must miss the bars (measured 8.7e-3 and 0.12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from stereo_match_tpu.models import mccnn as jm
from stereo_match_tpu_torch.models import mccnn as tm
from stereo_match_tpu_torch.parallel.mesh import named_mesh

STEP_RTOL = 1e-6
STEP_TOL = 1e-6
TRAIN_RTOL = 1e-5
MOVE_RTOL = 1e-5
LR_FAULT = 1.1


@pytest.fixture(scope="module", autouse=True)
def _first_sqrt():
    """torch 2.13's CPU ``sqrt`` can be off by about 1e-3 relative in its
    first multithreaded call of a process; make that call before the
    comparisons (as ``tests/test_torch_training.py`` does)."""
    a = torch.ones(96, 16, 12, 12)
    torch.sqrt(torch.sum(a * a, 1, keepdim=True) + 1e-12)


def _mesh(data, model):
    return named_mesh(["cpu"] * (data * model), (data, model),
                      ("data", "model"))


def _batch(n, patch, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, 1, (n, patch, patch)).astype(np.float32)
                 for _ in range(3))


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(leaf))
                           for leaf in jax.tree.leaves(tree)])


def test_partition_rules_match_jax():
    """The same regexes and, on the fast tower, the same spec per leaf."""
    assert [r for r, _ in tm.PARTITION_RULES] == \
        [r for r, _ in jm.PARTITION_RULES]
    assert [s for _, s in tm.PARTITION_RULES] == \
        [tuple(s) for _, s in jm.PARTITION_RULES]
    params = jm.init_params(jm.make_model("fast"), jax.random.PRNGKey(0))
    want = jm.match_partition_rules(jm.PARTITION_RULES, params)
    got = tm.match_partition_rules(tm.PARTITION_RULES,
                                   tm.to_flax_params(tm.make_model("fast")))
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_want) == 8
    for path, spec in flat_want:
        node = got
        for key in path:
            node = node[key.key]
        assert node == tuple(spec), (path, node, spec)
    kernels = [got["params"][f"conv{i}"]["kernel"] for i in range(4)]
    assert kernels == [(None, None, None, "model")] * 4
    assert tm.match_partition_rules(((r"conv0/", ("data",)),), got) \
        ["params"]["conv1"]["bias"] == ()


def test_shard_params_places_output_channels():
    model = tm.make_model((16, 2), seed=0)
    mesh = _mesh(2, 4)
    tower = tm.shard_params(model, mesh)
    assert len(tower.parameters()) == 2 * 4 * 2 * 2
    for r in range(2):
        for m in range(4):
            for i in range(2):
                w, b = tower.slices[r][m][i]
                assert w.device == mesh.devices[r, m]
                assert w.requires_grad and b.requires_grad and w.is_leaf
                assert torch.equal(w, model.weights[i][4 * m:4 * m + 4])
                assert torch.equal(b, model.biases[i][4 * m:4 * m + 4])
                assert w.data_ptr() != model.weights[i].data_ptr()
    # the rows hold copies of their own, not views of one tensor
    assert tower.slices[0][1][1][0].data_ptr() != \
        tower.slices[1][1][1][0].data_ptr()
    restored = tm.make_model((16, 2), seed=1)
    tower.gather_into(restored)
    for a, b in zip(restored.parameters(), model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="split"):
        tm.shard_params(tm.make_model((12, 2)), _mesh(1, 8))
    with pytest.raises(ValueError, match="data"):
        tm.shard_params(model, named_mesh(["cpu"] * 4, (2, 2),
                                          ("batch", "rows")))


def test_sharded_step_matches_jax():
    """One SGD step of the fast tower on a (data=4, model=2) mesh from the
    same flax parameters: the port's against JAX's sharded step."""
    model = jm.make_model("fast")
    params = jm.init_params(model, jax.random.PRNGKey(3))
    jmesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
    batch = _batch(8, 12)
    optimizer = optax.sgd(1e-2)
    sharded = jm.shard_params(params, jmesh)
    want_params, _, want_loss = jm.make_train_step(model, optimizer, jmesh)(
        sharded, optimizer.init(sharded),
        tuple(jnp.asarray(x) for x in batch))

    tower_model = tm.from_flax_params(params, "fast")
    mesh = _mesh(4, 2)
    tower = tm.shard_params(tower_model, mesh)
    step = tm.make_train_step(tower, torch.optim.SGD(tower.parameters(),
                                                     lr=1e-2), mesh)
    loss = float(step(*(torch.from_numpy(x) for x in batch)))
    tower.gather_into(tower_model)
    assert abs(loss - float(want_loss)) <= STEP_RTOL * abs(float(want_loss))
    got = tm.to_flax_params(tower_model)
    np.testing.assert_allclose(_flat(got), _flat(want_params), rtol=0,
                               atol=STEP_TOL)


def test_mesh_trainer_matches_single_device_trainer():
    """3 Adam steps on a (data=2, model=2) mesh against the single-device
    trainer from the same weights; a learning rate 10 % high misses."""
    flax = tm.to_flax_params(tm.make_model((16, 3), seed=0))
    batches = [_batch(8, 11, seed=s) for s in range(3)]
    start = _flat(flax)

    def run(lr, mesh=None):
        model, losses = tm.train(tm.from_flax_params(flax, (16, 3)), batches,
                                 lr, device="cpu", mesh=mesh)
        return _flat(tm.to_flax_params(model)) - start, losses

    move, losses = run(2e-3)
    for lr, ok in ((2e-3, True), (2e-3 * LR_FAULT, False)):
        m_move, m_losses = run(lr, _mesh(2, 2))
        assert len(m_losses) == 3
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(m_losses, losses))
        move_err = float(np.linalg.norm(m_move - move) / np.linalg.norm(move))
        assert (loss_err <= TRAIN_RTOL and move_err <= MOVE_RTOL) == ok, \
            (lr, loss_err, move_err)


def test_mesh_step_sums_gradients_over_data():
    """After a step's backward every row's copy of a slice holds the
    gradient of the whole batch's mean loss, which the single-device
    tower gives (within float32 sums in another order)."""
    model = tm.make_model((8, 2), seed=2)
    a, p, n = (torch.from_numpy(x) for x in _batch(6, 9, seed=4))
    mesh = _mesh(3, 2)
    tower = tm.shard_params(model, mesh)
    seen = []
    step = tm.make_train_step(tower, _Record(tower.parameters(), seen),
                              mesh)
    loss = step(a, p, n)
    model.requires_grad_(True)
    want = tm.hinge_loss(model, a, p, n)
    want.backward()
    assert abs(float(loss) - want.item()) <= 1e-6 * want.item()
    grads = dict(zip(map(id, tower.parameters()), seen))
    for r in range(3):
        for m in range(2):
            for i in range(2):
                for k, full in enumerate((model.weights[i],
                                          model.biases[i])):
                    g = grads[id(tower.slices[r][m][i][k])]
                    ref = full.grad[4 * m:4 * m + 4]
                    assert float((g - ref).abs().max()) <= \
                        1e-6 * float(full.grad.norm())
    with pytest.raises(ValueError, match="split"):
        step(a[:5], p[:5], n[:5])
    with pytest.raises(ValueError, match="shard_params"):
        tm.make_train_step(model, _Record(model.parameters(), []), mesh)


class _Record(torch.optim.Optimizer):
    """An optimizer that records the gradients it is given and moves
    nothing."""

    def __init__(self, params, seen):
        super().__init__(list(params), {})
        self.seen = seen

    @torch.no_grad()
    def step(self, closure=None):
        self.seen[:] = [q.grad.clone() for group in self.param_groups
                        for q in group["params"]]
