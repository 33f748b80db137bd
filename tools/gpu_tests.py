#!/usr/bin/env python3
"""Run the port's ``gpu``-marked tests on a machine with a card but no
JAX (the card's machine has none, and ``tests/conftest.py`` imports it).

    python3 tools/gpu_tests.py [pytest arguments]

Before pytest starts, a meta-path finder answers every import of ``jax``,
``jaxlib``, ``flax`` and ``nnstreamer_tpu`` with an empty module whose
attributes are mocks: the ``gpu`` tests use only the port, and the CPU
tests they sit beside are deselected. ``tests`` is bound to this
checkout's directory first, ahead of any installed package of that name.
Without arguments it runs the test files that hold a ``gpu`` test; pass
test files to narrow it. A ``gpu`` test that compares the card with the
JAX package itself gets a mock for the JAX side and fails here:
``tests/test_torch_quant.py::test_device_blob_matches_host_blob_on_the_card``
(every other ``gpu`` test passes on an H100). A ``gpu`` test therefore
writes its configuration out instead of importing it from a JAX test
module, whose values the stub replaces with mocks.
"""

import importlib.abc
import importlib.machinery
import os
import sys
import types
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUBBED = ("jax", "jaxlib", "flax", "nnstreamer_tpu")


class _Stubs(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in STUBBED:
            return importlib.machinery.ModuleSpec(name, self,
                                                  is_package=True)
        return None

    def create_module(self, spec):
        module = types.ModuleType(spec.name)
        module.__path__ = []
        module.__dict__["__getattr__"] = lambda attr: mock.MagicMock()
        return module

    def exec_module(self, module):
        pass


def gpu_test_files():
    tests = os.path.join(ROOT, "tests")
    return sorted(os.path.join("tests", name) for name in os.listdir(tests)
                  if name.startswith("test_") and name.endswith(".py") and
                  "pytest.mark.gpu" in open(os.path.join(tests, name)).read())


def main() -> int:
    import pytest

    sys.path.insert(0, ROOT)
    sys.meta_path.insert(0, _Stubs())
    package = types.ModuleType("tests")
    package.__path__ = [os.path.join(ROOT, "tests")]
    sys.modules["tests"] = package
    os.chdir(ROOT)
    args = sys.argv[1:] or gpu_test_files()
    return pytest.main(["-m", "gpu", "-q", "-rs", "-p", "no:cacheprovider",
                        "-p", "no:randomly", *args])


if __name__ == "__main__":
    sys.exit(main())
