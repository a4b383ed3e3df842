"""The port's public surface against the JAX package's.

``repro_torch.api.__all__`` is ``repro.api.__all__`` plus ``KernelError``;
``repro_torch.core.__all__`` is ``repro.core.__all__``, the five sharded
engines included, with ``kernel_builds`` where the JAX package has
``jit_compiles``.  Every public signature of ``repro_torch.api`` equals its
record in ``tests/api_surface.json`` (read here, never written), apart from
the ``device`` keyword the port adds.
"""
import inspect
import json
import pathlib
import re

import pytest

from repro import api as ref_api
from repro import core as ref_core
from repro_torch import api
from repro_torch import core
from test_api_surface import _describe_callable, _describe_class

LOCKFILE = pathlib.Path(__file__).with_name("api_surface.json")


def _entry(obj) -> dict:
    """One surface record, in the lockfile's format."""
    if inspect.isclass(obj):
        if issubclass(obj, BaseException):
            return {"kind": "exception", "bases": sorted(
                b.__name__ for b in obj.__mro__[1:]
                if b not in (object, BaseException))}
        return {"kind": "class", "methods": _describe_class(obj)}
    return {"kind": "function", "signature": _describe_callable(obj)}


def _without_device(text: str) -> str:
    """A signature text without the port's ``device`` keyword, with the
    port's module paths spelled as the JAX package's."""
    text = re.sub(r", device='cuda'|, \*, device='cuda'|, device=\"cuda\"",
                  "", text)
    text = re.sub(r", device(?=[,)])", "", text)
    return text.replace("repro_torch.", "repro.")


def _normalised(entry: dict) -> dict:
    if "signature" in entry:
        return dict(entry, signature=_without_device(entry["signature"]))
    if "methods" in entry:
        return dict(entry, methods={k: _without_device(v)
                                    for k, v in entry["methods"].items()})
    return entry


def test_api_all_is_the_reference_list_plus_kernel_error():
    assert api.__all__ == list(ref_api.__all__) + ["KernelError"]
    for name in api.__all__:
        assert hasattr(api, name), name
    assert issubclass(api.KernelError, api.DDMError)


def test_core_all_is_the_reference_list_with_kernel_builds():
    want = [("kernel_builds" if n == "jit_compiles" else n)
            for n in ref_core.__all__]
    assert core.__all__ == want
    for name in core.__all__:
        assert hasattr(core, name), name


@pytest.mark.parametrize("name", sorted(ref_api.__all__))
def test_signature_equals_the_lockfile_record(name):
    locked = json.loads(LOCKFILE.read_text())[name]
    got = _entry(getattr(api, name))
    assert _normalised(got) == locked


def test_device_is_the_only_added_keyword_and_defaults_to_cuda():
    """Where a signature differs from the record at all, the difference is
    a ``device`` keyword defaulting to ``cuda``."""
    assert "device='cuda'" in _describe_callable(api.replay_journal)
    service = inspect.signature(api.DDMService)
    assert service.parameters["device"].default == "cuda"
    bare = _without_device(_describe_callable(api.replay_journal))
    assert "device" not in bare
