"""ParamAttr (reference python/paddle/fluid/param_attr.py:ParamAttr),
copied from ``paddle_tpu/nn/param_attr.py``."""


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @classmethod
    def _to_attr(cls, attr):
        from .initializer import Initializer
        if attr is None or isinstance(attr, cls):
            return attr
        if isinstance(attr, Initializer):
            return cls(initializer=attr)
        if isinstance(attr, str):
            return cls(name=attr)
        if attr is False:
            return False
        return cls()
