"""The port's tensor / expert parallel placement (parallel/sharding.py)
against the JAX package's `param_spec` / `state_shardings`, and the
cutting and gathering of a state, on the CPU.

The placement is compared leaf by leaf through the weight converters: each
JAX leaf becomes an array that holds, per element, the model-axis index of
the rank that holds it under the JAX rule (-1: every rank), and goes
through `vae_state_dict_from_jax` / `teacher_state_dict_from_jax` (which
transpose the linear weights, reorder the bottleneck and unstack the
experts), so the port's rule must give the same owner to the same element
of the port's tensor."""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_kernels import torch_threads  # noqa: F401 (autouse)

# (model axis M, experts E, latent L, shard_experts): M = 1, 2, 4; experts
# on and off; E % M != 0 (experts replicated) and L % M != 0 (the FC pair
# replicated).
SPEC_CASES = ((1, 2, 16, True), (2, 2, 16, True), (2, 2, 16, False),
              (4, 4, 16, True), (4, 2, 16, True), (4, 4, 18, True))


def _configs(num_experts, latent):
    from lunaris_orion_tpu_torch.config import (TeacherConfig, TrainConfig,
                                                VAEConfig)
    vcfg = VAEConfig(latent_dim=latent, image_size=16, base_channels=16)
    tcfg = TeacherConfig(
        num_experts=num_experts, feature_dim=16, extractor_dim=16,
        extractor_stem=8, branch_dim=8, expert_layers=2, intermediate_dim=16,
        embedding_dim=8, num_heads=4, rel_pos_size=4, image_size=16)
    cfg = TrainConfig(batch_size=4, latent_dim=latent, feature_dim=16,
                      num_experts=num_experts, embedding_dim=8, image_size=16)
    return cfg, vcfg, tcfg


def _jax_owners(tree, model_size, num_experts, latent, shard_experts):
    """Each leaf of a JAX state subtree as an f32 array of owners under the
    JAX rule (the path as `state_shardings` sees it: the subtree's name
    first)."""
    import jax
    from lunaris_orion_tpu.parallel.sharding import _path_str, param_spec

    def owners(path, leaf):
        spec = param_spec(_path_str(path), leaf, model_size=model_size,
                          num_experts=num_experts, latent_dim=latent,
                          shard_experts=shard_experts)
        out = np.full(leaf.shape, -1.0, np.float32)
        for d, axis in enumerate(spec):
            if axis == "model":
                per = leaf.shape[d] // model_size
                shape = [1] * len(leaf.shape)
                shape[d] = leaf.shape[d]
                out = np.broadcast_to(
                    (np.arange(leaf.shape[d]) // per).reshape(shape),
                    leaf.shape).astype(np.float32)
        return out
    return jax.tree_util.tree_map_with_path(owners, tree)


def _port_owners(sd, layout, model_size):
    """The port's owner arrays of a state_dict under `layout`."""
    from lunaris_orion_tpu_torch.parallel.sharding import EXPERT, expert_index
    out = {}
    for k, v in sd.items():
        a = np.full(tuple(v.shape), -1.0, np.float32)
        spec = None if layout is None else layout.spec(k, v)
        if spec == EXPERT:
            a[...] = layout.owner(expert_index(k))
        elif spec is not None:
            shape = [1] * v.dim()
            shape[spec] = v.shape[spec]
            per = v.shape[spec] // model_size
            a = np.broadcast_to((np.arange(v.shape[spec]) // per).reshape(
                shape), a.shape).astype(np.float32)
        out[k] = a
    return out


def _layout(model_size, index, num_experts, latent, shard_experts):
    from lunaris_orion_tpu_torch.parallel.mesh import AxisGroup
    from lunaris_orion_tpu_torch.parallel.sharding import Layout
    return Layout(AxisGroup(None, index, model_size, tuple(range(model_size))),
                  num_experts, latent, shard_experts)


@pytest.mark.parametrize("case", SPEC_CASES, ids=[
    f"M{m}-E{e}-L{lat}-{'ep' if s else 'noep'}" for m, e, lat, s in SPEC_CASES])
def test_param_spec_matches_jax(case):
    """Every parameter, BatchNorm statistic and AdamW first moment of the
    tiny state: the same elements go to the same model rank under the
    port's `param_spec` as under the JAX package's (the same split
    dimension after the [out, in] transpose, the same expert ownership,
    the same fall-backs to replicated), exactly. The port's own buffers
    (BatchNorm's `num_batches_tracked`, the attention's
    `last_spatial_shapes`) go with their expert."""
    import jax
    from lunaris_orion_tpu import config as jconfig
    from lunaris_orion_tpu.train import state as jstate
    from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
    from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
    from lunaris_orion_tpu_torch.parallel.sharding import (EXPERT,
                                                          expert_index,
                                                          param_spec)
    from lunaris_orion_tpu_torch.utils.convert import (
        teacher_state_dict_from_jax, vae_state_dict_from_jax)
    m, e, lat, shard = case
    cfg, vcfg, tcfg = _configs(e, lat)
    abstract = jax.eval_shape(lambda k: jstate.create_state(
        k, jconfig.TrainConfig(**dataclasses.asdict(cfg)),
        jconfig.VAEConfig(**dataclasses.asdict(vcfg)),
        jconfig.TeacherConfig(**dataclasses.asdict(tcfg))),
        jax.random.PRNGKey(0))
    trees = _jax_owners({"vae_params": abstract.vae_params,
                         "teacher_params": abstract.teacher_params,
                         "teacher_stats": abstract.teacher_stats,
                         "vae_mu": abstract.vae_opt[1][0].mu},
                        m, e, lat, shard)
    want = {
        "vae": vae_state_dict_from_jax(trees["vae_params"], vcfg),
        "vae_mu": vae_state_dict_from_jax(trees["vae_mu"], vcfg),
        "teacher": teacher_state_dict_from_jax(
            trees["teacher_params"], trees["teacher_stats"], tcfg)}
    layout = _layout(m, 0, e, lat, shard) if m > 1 else None
    models = {"vae": LunarisCoreVAE(vcfg), "teacher": LunarMoETeacher(tcfg)}
    models["vae_mu"] = models["vae"]
    n = 0
    for name, sd_want in want.items():
        sd = models[name].state_dict()
        got = _port_owners(sd, layout, m)
        assert set(sd_want) == set(sd)
        for k, w in sd_want.items():
            if k.endswith(("num_batches_tracked", "last_spatial_shapes")):
                spec = param_spec(k, sd[k], model_size=m, num_experts=e,
                                  latent_dim=lat, shard_experts=shard)
                assert spec == (EXPERT if m > 1 and shard and e % m == 0
                                and expert_index(k) is not None else None), k
                continue
            np.testing.assert_array_equal(got[k], w.numpy(), err_msg=k)
            n += 1
    assert n > 100
    split = {k for k, v in models["vae"].state_dict().items()
             if layout is not None and layout.spec(k, v) is not None}
    assert split == ({"encoder.fc_mu.weight", "encoder.fc_mu.bias",
                      "encoder.fc_logvar.weight", "encoder.fc_logvar.bias",
                      "decoder.fc.weight"} if m > 1 and lat % m == 0
                     else set())


def test_shard_then_gather_is_the_state():
    """`shard_state` on each of 2 model ranks keeps the rank's latent
    slice of the FC pair and its experts (with their quality heads and
    BatchNorm buffers), and moments cut like their parameters; the
    ranks' parts put back together are the whole state, bit for bit.
    Checked without a process group: the layout's `part` of the whole
    tensors is what each rank keeps."""
    from lunaris_orion_tpu_torch.parallel.sharding import _shard_model
    from lunaris_orion_tpu_torch.train.state import create_state
    cfg, vcfg, tcfg = _configs(4, 16)
    whole = create_state(cfg, "cpu", 0, vcfg, tcfg)
    for opt, model in ((whole.vae_opt, whole.vae),
                       (whole.teacher_opt, whole.teacher)):
        for p in model.parameters():            # moments as after a step
            opt.opt.state[p] = {"step": torch.tensor(1.0),
                                "exp_avg": torch.randn_like(p),
                                "exp_avg_sq": torch.rand_like(p)}
    full = {f"{m}.{k}": v.clone() for m, mod in (("vae", whole.vae),
                                                 ("teacher", whole.teacher))
            for k, v in mod.state_dict().items()}
    moments = {f"{m}.{k}": {n: t.clone() for n, t in
                            opt.opt.state[p].items()}
               for m, mod, opt in (("vae", whole.vae, whole.vae_opt),
                                   ("teacher", whole.teacher,
                                    whole.teacher_opt))
               for k, p in mod.named_parameters()}
    seen = {}
    for index in range(2):
        st = create_state(cfg, "cpu", 0, vcfg, tcfg)
        for opt, model, prefix in ((st.vae_opt, st.vae, "vae"),
                                   (st.teacher_opt, st.teacher, "teacher")):
            for k, p in model.named_parameters():
                opt.opt.state[p] = {n: t.clone() for n, t in
                                    moments[f"{prefix}.{k}"].items()}
        layout = _layout(2, index, 4, 16, True)
        vae_opt = _shard_model(st.vae, st.vae_opt, layout)
        teacher_opt = _shard_model(st.teacher, st.teacher_opt, layout)
        assert [i for i, ex in enumerate(st.teacher.experts)
                if ex is not None] == [2 * index, 2 * index + 1]
        assert [i for i, h in enumerate(st.teacher.quality_heads)
                if h is not None] == [2 * index, 2 * index + 1]
        assert st.vae.encoder.fc_mu.weight.shape[0] == 8
        assert st.vae.decoder.fc.weight.shape[1] == 8
        assert st.vae.decoder.fc.bias.shape[0] == vcfg.bottleneck_dim
        for m, mod, opt in (("vae", st.vae, vae_opt),
                            ("teacher", st.teacher, teacher_opt)):
            assert opt.axis is layout.axis
            assert sum(opt.split) == sum(
                layout.spec(k, full[f"{m}.{k}"]) is not None
                for k, _ in mod.named_parameters())
            for k, v in mod.state_dict().items():
                name = f"{m}.{k}"
                np.testing.assert_array_equal(
                    v.numpy(), layout.part(k, full[name]).numpy(), err_msg=k)
                seen.setdefault(name, []).append(v)
            for (k, p), part in zip(mod.named_parameters(), opt.split):
                st_p = opt.opt.state[p]
                assert part == (layout.spec(k, full[f"{m}.{k}"]) is not None)
                for n in ("exp_avg", "exp_avg_sq"):
                    assert st_p[n].shape == p.shape
                    np.testing.assert_array_equal(
                        st_p[n].numpy(), layout.part(
                            k, moments[f"{m}.{k}"][n]).numpy())
    for name, parts in seen.items():
        k = name.split(".", 1)[1]
        spec = _layout(2, 0, 4, 16, True).spec(k, full[name])
        got = (parts[0] if spec is None or len(parts) == 1
               else torch.cat(parts, dim=spec))
        np.testing.assert_array_equal(got.numpy(), full[name].numpy(),
                                      err_msg=name)
        assert len(parts) == (1 if spec == "expert" else 2)
    assert set(seen) == set(full)
