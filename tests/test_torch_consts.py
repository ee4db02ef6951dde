"""The port's ``core/consts.py`` getters and ``AssemblyConfig`` against the
JAX package's: every getter's value, and ``as_params_dict()`` and every
field's default for a default and a non-default configuration."""

import dataclasses

import pytest

from genome_assembly_tpu.core import AssemblyConfig as JaxConfig
from genome_assembly_tpu.core import consts as jax_consts
from genome_assembly_tpu_torch.core import AssemblyConfig
from genome_assembly_tpu_torch.core import consts

GETTERS = ("get_lower_bound_l", "get_upper_bound_l", "get_lower_bound_n",
           "get_upper_bound_n", "get_lower_bound_p", "get_upper_bound_p",
           "get_big_n", "get_metrics", "get_metric_labels")

NON_DEFAULT = {"num_reads": 90_000, "read_length": 150, "error_prob": 0.005,
               "k": 15, "num_iteration": 3, "experiment_name": "long",
               "match_score": 5, "mismatch": -4, "indel": -2,
               "exact_parity": False, "use_native": False,
               "device_scoring": False, "verbose": True}


def test_the_getters_are_the_jax_packages():
    public = sorted(n for n in dir(jax_consts) if n.startswith("get_"))
    assert sorted(GETTERS) == public
    assert sorted(n for n in dir(consts) if n.startswith("get_")) == public


@pytest.mark.parametrize("name", GETTERS)
def test_getter_equals_jax(name):
    got, want = getattr(consts, name)(), getattr(jax_consts, name)()
    assert got == want
    assert type(got) is type(want)


def test_list_getters_return_fresh_copies():
    consts.get_metrics().append("x")
    consts.get_metric_labels().clear()
    assert consts.get_metrics() == jax_consts.get_metrics()
    assert consts.get_metric_labels() == jax_consts.get_metric_labels()


def test_fields_and_defaults_equal_jax():
    fields = [(f.name, f.default) for f in dataclasses.fields(AssemblyConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(JaxConfig)]


@pytest.mark.parametrize("kwargs", [{}, NON_DEFAULT,
                                    {"num_reads": 1, "k": 31}],
                         ids=["default", "every field", "two fields"])
def test_as_params_dict_equals_jax(kwargs):
    got = AssemblyConfig(**kwargs)
    want = JaxConfig(**kwargs)
    assert got.as_params_dict() == want.as_params_dict()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
