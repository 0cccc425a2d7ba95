"""HuBERT-XLarge's raFLoRA round (``chip_smoke.py`` main path 20's, at
reduced size) in the port, held to the JAX package on the CPU: the audio
frontend (frame embeddings through ``frontend_proj``, no token table
read), bidirectional attention with qkv bias, LoRA on q/k/v/o.

Both packages build the reduced model (2 layers, d 256) from the same JAX
weights (``convert.params_from_numpy``), the same clients and ranks (4
clients, all sampled, at rank levels 4/8/16), and the same frame batches:
``ClusterClassification`` clips (bit-equal in both packages) partitioned
by class, the label read at position 0 (``to_batch``). One round of the
batched engine on the kernel backend (the reference's Pallas kernels in
interpret mode, the port's kernels' plain versions) with the tolerances
of ``test_torch_round.py::test_batched_kernel_round_matches_jax``: loss
rtol 1e-4, spectra atol 1e-3 and products atol 2e-3 of max(1,
sigma_max), rho_{r1} atol 1e-3. The q/k/v/o adapters of both layers make
one shape bucket (L = 8), so K1 and K2 each run once."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import FLConfig as JFL
from repro.configs import LoRAConfig as JLoRA
from repro.configs import get_config as j_config
from repro.data import ClusterClassification as JClips
from repro.data import batches as j_batches
from repro.data import make_partition as j_partition
from repro.federation import ClientRegistry as JRegistry
from repro.federation import FederatedLoRA as JServer
from repro.federation.experiment import _to_batch as j_to_batch
from repro.models import build_model
from repro_torch.configs import FLConfig, LoRAConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import ClusterClassification, make_partition
from repro_torch.federation import ClientRegistry
from repro_torch.federation.experiment import make_batch_fn
from repro_torch.federation.server import FederatedLoRA
from repro_torch.kernels import ops
from repro_torch.models.transformer import Model
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

NAME = "hubert-xlarge"
LORA = dict(rank_levels=(4, 8, 16), rank_probs=(1 / 3,) * 3)
FL = dict(aggregator="raflora", num_clients=4, participation=1.0,
          num_rounds=1, local_batch_size=2, learning_rate=2e-3,
          partition="pathological", labels_per_client=2)
CLIPS = dict(num_classes=4, patches=16, samples_per_class=4, seed=5)


def _clips(dim):
    """The clips from the port's copy, checked bit-equal to the
    reference's."""
    x, y = ClusterClassification(dim=dim, **CLIPS).generate()
    jx, jy = JClips(dim=dim, **CLIPS).generate()
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    return x, y


def _servers():
    """The reference's and the port's batched kernel-backend servers over
    reduced HuBERT-XLarge from the same JAX weights and frame batches."""
    jcfg = j_config(NAME).reduced()
    jm = build_model(jcfg, JLoRA(**LORA), dtype=jnp.float32, remat=False,
                     block_q=16, block_kv=16)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    x, y = _clips(jcfg.frontend.embed_dim)
    positions = CLIPS["patches"]

    jfl, jlora = JFL(**FL), JLoRA(**LORA)
    jreg = JRegistry.create(jfl, jlora, j_partition(
        jfl.partition, y, jfl.num_clients,
        labels_per_client=jfl.labels_per_client, seed=jfl.seed))

    def j_batch_fn(cid, rng):
        idx = jreg.shards[cid]
        bx, by = next(j_batches(x[idx], y[idx], jfl.local_batch_size, rng))
        return [j_to_batch(bx, by, positions)]
    js = JServer(jm, jfl, jlora, jreg, j_batch_fn, base_params=jp,
                 backend="kernel", round_engine="batched")

    fl, lora = FLConfig(**FL), LoRAConfig(**LORA)
    reg = ClientRegistry.create(fl, lora, make_partition(
        fl.partition, y, fl.num_clients,
        labels_per_client=fl.labels_per_client, seed=fl.seed))
    ts = FederatedLoRA(
        Model(get_config(NAME).reduced(), lora, device="cpu", remat=False),
        fl, lora, reg, make_batch_fn(reg, x, y, fl, 1, positions),
        base_params=params_from_numpy(jp, "cpu"), backend="kernel")
    return js, ts


def _factors(server):
    r_max = server.lora_cfg.r_max
    return {tuple(p): tuple(np.asarray(x) for x in f) for p, f in
            server._extract_factors(server.global_lora, r_max).items()}


def test_hubert_round_matches_reference(monkeypatch):
    """One round from identical state: the same clients and ranks; loss,
    spectra, the higher-rank energy ratio and every adapter product
    within the round tolerances; the four adapters in the reference's
    order; one bucket, so each of K1 and K2 runs once through the kernel
    API."""
    calls = {name: 0 for name in ("weighted_stack_b", "weighted_stack_a",
                                  "gram_left", "gram_right")}
    for name in calls:
        inner = getattr(ops, name)

        def counted(*a, _name=name, _inner=inner):
            calls[_name] += 1
            return _inner(*a)
        monkeypatch.setattr(ops, name, counted)
    js, ts = _servers()
    (sj,), (st,) = js.run(1), ts.run(1)
    assert st.clients == sj.clients and st.ranks == sj.ranks
    np.testing.assert_allclose(st.mean_client_loss, sj.mean_client_loss,
                               rtol=1e-4)
    assert np.isfinite(st.mean_client_loss)
    scale = max(1.0, float(np.abs(sj.sigma_probe).max()))
    np.testing.assert_allclose(st.sigma_probe, sj.sigma_probe,
                               atol=1e-3 * scale)
    np.testing.assert_allclose(ts.energy.rho_r1, js.energy.rho_r1,
                               atol=1e-3)
    fj, ft = _factors(js), _factors(ts)
    assert list(ft) == list(fj) and len(fj) == 4
    for parent, (b, a) in fj.items():
        tb, ta = ft[parent]
        np.testing.assert_allclose(tb @ ta, b @ a, atol=2e-3 * scale,
                                   err_msg=str(parent))
    assert calls == dict.fromkeys(calls, 1)
