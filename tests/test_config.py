import pytest

from driftscan_tpu import config


class Widget(config.Reader):
    length = config.Property(proptype=float, default=1.0)
    name = config.Property(proptype=str, default="w")
    tsys = config.Property(proptype=float, default=50.0, key="tsys_key")
    mode = config.enum(["a", "b"], default="a")
    items = config.list_type(type_=int, default=[1])


class SubWidget(Widget):
    extra = config.Property(proptype=int, default=3)


def test_defaults():
    w = Widget()
    assert w.length == 1.0
    assert w.mode == "a"
    assert w.items == [1]


def test_from_config():
    w = Widget.from_config(
        {"length": 2, "tsys_key": "7.5", "mode": "b", "items": [3, 4]}
    )
    assert w.length == 2.0
    assert w.tsys == 7.5
    assert w.mode == "b"
    assert w.items == [3, 4]


def test_inherited_properties():
    w = SubWidget.from_config({"length": 5, "extra": 9})
    assert w.length == 5.0
    assert w.extra == 9


def test_instances_independent():
    a, b = Widget(), Widget()
    a.length = 10.0
    assert b.length == 1.0


def test_enum_rejects():
    with pytest.raises(config.CaputConfigError):
        Widget.from_config({"mode": "nope"})


def test_constructor_args_passed():
    class Holder(config.Reader):
        x = config.Property(proptype=int, default=0)

        def __init__(self, parent, tag="t"):
            self.parent = parent
            self.tag = tag

    h = Holder.from_config({"x": 4}, "p", tag="z")
    assert h.parent == "p" and h.tag == "z" and h.x == 4


def test_matmul_precision_default():
    """The library must pin full-f32 matmul precision: reduced-precision
    f32 matmuls (TF32 on GPU tensor cores, unit roundoff ~5e-4) would
    violate the reference's rel-1e-4 beam_m tier."""
    import jax

    import driftscan_tpu  # noqa: F401  (import applies the config)

    assert jax.config.jax_default_matmul_precision == "highest"
