"""The port's own copy of the configuration dataclasses
(lunaris_orion_tpu_torch/config.py) against the JAX package's: the same
fields in the same order with the same types and defaults, the same derived
properties, and a lossless round trip between the two, so that the copy
cannot drift unnoticed."""

import dataclasses

import pytest

from lunaris_orion_tpu import config as jcfg
from lunaris_orion_tpu_torch import config as tcfg

NAMES = ("VAEConfig", "TeacherConfig", "TrainConfig")
PROPERTIES = {"VAEConfig": ("num_down", "channels", "bottleneck_hw",
                            "bottleneck_dim"),
              "TeacherConfig": ("head_dim",), "TrainConfig": ()}


@pytest.mark.parametrize("name", NAMES)
def test_fields_and_defaults_match(name):
    ours, theirs = getattr(tcfg, name), getattr(jcfg, name)
    assert ours is not theirs
    f_ours, f_theirs = dataclasses.fields(ours), dataclasses.fields(theirs)
    assert [f.name for f in f_ours] == [f.name for f in f_theirs]
    for a, b in zip(f_ours, f_theirs):
        assert a.type == b.type, a.name
        assert a.default == b.default, a.name
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(ours(), f_ours[0].name, 1)


@pytest.mark.parametrize("name", NAMES)
def test_derived_properties_match(name):
    props = {k for k, v in vars(getattr(jcfg, name)).items()
             if isinstance(v, property)}
    assert props == set(PROPERTIES[name])
    kw = {"VAEConfig": dict(latent_dim=32, image_size=48, base_channels=16,
                            channel_mults=(1, 2, 4)),
          "TeacherConfig": dict(feature_dim=96, num_heads=4),
          "TrainConfig": {}}[name]
    for cfg_kw in ({}, kw):
        a, b = getattr(tcfg, name)(**cfg_kw), getattr(jcfg, name)(**cfg_kw)
        for prop in props:
            assert getattr(a, prop) == getattr(b, prop), prop


def test_train_config_methods_match():
    kw = dict(latent_dim=64, feature_dim=32, embedding_dim=16, num_experts=2,
              image_size=64, attn_window=256, mesh_shape=(2, 1))
    a, b = tcfg.TrainConfig(**kw), jcfg.TrainConfig(**kw)
    assert a.to_dict() == b.to_dict()
    assert tcfg.TrainConfig().to_dict() == jcfg.TrainConfig().to_dict()
    for sub in ("vae_config", "teacher_config"):
        assert dataclasses.asdict(getattr(a, sub)()) == dataclasses.asdict(
            getattr(b, sub)())
    assert a.replace(batch_size=4).batch_size == 4
    # Round trips: either package's dict builds the other's config; unknown
    # keys are dropped and a JSON list becomes the mesh tuple again.
    d = dict(b.to_dict(), mesh_shape=[2, 1], not_a_field=1)
    assert tcfg.TrainConfig.from_dict(d) == a
    assert jcfg.TrainConfig.from_dict(a.to_dict()) == b


def test_reference_args_helper_matches():
    from lunaris_orion_tpu.utils.torch_compat import (
        train_config_from_reference_args as theirs)
    from lunaris_orion_tpu_torch.utils.convert import (
        train_config_from_reference_args as ours)
    args = {"latent_dim": 32, "batch_size": 8, "mixed_precision": True,
            "a_flag_of_the_reference_only": 3}
    assert ours(args).to_dict() == theirs(args).to_dict()
