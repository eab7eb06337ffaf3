"""``QuantConfig``: port of ``paddle_tpu/quantization/config.py``.

Quanter factories by layer, by attribute path, by type, or for every
layer. A layer's config is keyed by its ``full_name()``, so it survives
the deep copy inside ``Quantization.quantize``; a plain
``torch.nn.Module`` has none, and gets one (``_full_name``) the first
time a config looks at it, stored on the module so that a deep copy
keeps it too.
"""
from ..utils.unique_name import generate as _unique_name

__all__ = ["SingleLayerConfig", "QuantConfig"]


class SingleLayerConfig:
    def __init__(self, activation=None, weight=None):
        self.activation = activation
        self.weight = weight


def _full_name(layer):
    """``layer.full_name()``, or for a plain module a unique name kept in
    its ``__dict__``."""
    if hasattr(layer, "full_name"):
        return layer.full_name()
    name = layer.__dict__.get("_quant_full_name")
    if name is None:
        name = _unique_name(type(layer).__name__.lower())
        layer.__dict__["_quant_full_name"] = name
    return name


class QuantConfig:
    """Layers -> quanter factories: ``add_layer_config`` (these layers),
    ``add_name_config`` (dotted attribute paths), ``add_type_config``
    (instances of these types), else the ``activation`` / ``weight``
    given here for every layer QAT can swap."""

    def __init__(self, activation=None, weight=None):
        self._default = SingleLayerConfig(activation, weight)
        self._by_layer = {}     # full name -> cfg
        self._by_name = {}      # dotted attribute path -> cfg
        self._by_type = {}      # type -> cfg
        from .qat import _DEFAULT_QAT_MAPPING   # qat imports this module
        self._qat_mapping = dict(_DEFAULT_QAT_MAPPING)

    def add_layer_config(self, layer, activation=None, weight=None):
        layers = layer if isinstance(layer, (list, tuple)) else [layer]
        for l in layers:
            self._by_layer[_full_name(l)] = SingleLayerConfig(
                activation, weight)

    def add_name_config(self, name, activation=None, weight=None):
        names = name if isinstance(name, (list, tuple)) else [name]
        for n in names:
            self._by_name[n] = SingleLayerConfig(activation, weight)

    def add_type_config(self, layer_type, activation=None, weight=None):
        types = layer_type if isinstance(layer_type, (list, tuple)) \
            else [layer_type]
        for t in types:
            self._by_type[t] = SingleLayerConfig(activation, weight)

    def add_qat_layer_mapping(self, source, target):
        self._qat_mapping[source] = target

    def _config_for(self, layer, name):
        key = _full_name(layer)
        if key in self._by_layer:
            return self._by_layer[key]
        if name in self._by_name:
            return self._by_name[name]
        for t, cfg in self._by_type.items():
            if isinstance(layer, t):
                return cfg
        if self._default.activation or self._default.weight:
            return self._default
        return None
