"""The benchmark's plain models, one module a model type:
``perfbench/models/<model_type>.py``, found by the ``model_type`` that a
configuration's frozen ``.conf`` names.  ``modelconf.load`` reads the
model-independent part of the file and hands the rest to the type's
module; the weights, the plain reference and the entries' work counts
get the module from ``of(conf.model_type)``.  A model type joins the
benchmark through its module alone: no file that is there is edited.

A module is plain PyTorch and NumPy beside the reference's shared parts
(``reference/model.py``: ``Lookups``, ``pool_mean``, the batch keys) and
imports nothing of the program under test.  It holds:

``Conf``
    A dataclass, ``modelconf.ModelConf``'s subclass declared with
    ``kw_only=True``: the model's own keys.
``WIDTHS``
    {attribute: value} of the published widths, which every
    configuration of the type keeps (``reduced`` never names a width).
``read(cp) -> dict``
    The model's own keys, by ``Conf``'s field names, from the frozen
    ``.conf`` as a ``configparser.ConfigParser``.
``check(conf, cp)``
    Raises ``ValueError`` for what the plain reference does not cover.
``layout(conf) -> list``
    ``(path, shape, dtype, init)`` of every parameter leaf: ``path`` as
    the program's parameter tree names it, ``dtype`` ``"float32"`` or
    ``"bfloat16"``, ``init`` ``("uniform", limit)`` or ``("const",
    value)`` (``weights.make`` draws the leaves).
``forward(conf, params, batch, lookups, *, train, gen=None)``
    The model's output on a batch keyed as ``traffic/batches.py`` makes
    it, its tables read through ``lookups`` (a ``Lookups``).  ``train``
    False is serving's forward; in training the dropout masks come from
    ``gen``.
``loss(conf, out, batch)``
    The training loss of a training forward's output, a scalar tensor.
``scores(conf, out)``
    ``(Scores, click_Scores, order_Scores)``, each ``[candidates]``, of a
    serving forward's output.
``train_step_ops(conf, lens) -> float``
    Operations of one training step over a batch whose id features have
    the lengths ``lens`` (feature -> ``[B]`` array).
``request_ops(conf, lens, candidates) -> float``
    Operations of the forward one request needs (``lens``: feature -> its
    length in the request).
``train_kernel_s(conf, lens_list) -> dict``
    The least seconds of each kernel family's work over the traced
    training steps (one ``lens`` a step), keyed by the names that the
    readers of ``perfbench/metrics/`` read (``block_s``,
    ``attention_s``); a family that the model does not run is left out
    or 0.
``serve_kernel_s(conf, lens_list, candidates) -> dict``
    The same over the requests of the traced serving stretch, one
    ``lens`` a request, in the order of their forwards.
"""

from __future__ import annotations

import importlib.util
import os
import sys

MODEL_DIR = os.path.dirname(os.path.abspath(__file__))
_LOADED: dict = {}


def of(model_type: str):
    """The module of ``model_type``; a type without one raises
    ``ValueError`` naming the file to add."""
    path = os.path.join(MODEL_DIR, model_type + ".py")
    if path not in _LOADED:
        if not os.path.isfile(path):
            raise ValueError(f"model_type {model_type!r} has no plain model "
                             f"in the benchmark: add perfbench/models/"
                             f"{model_type}.py ({path} not found)")
        # named inside this package, so that its relative imports resolve,
        # and registered, as a dataclass's module has to be
        spec = importlib.util.spec_from_file_location(
            f"{__name__}.{model_type}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
