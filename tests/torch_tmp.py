"""Autouse fixtures that delete what the port's tests write under pytest's
temporary directories once they have read it.

A test file imports both names (``from torch_tmp import
delete_module_tmp, delete_tmp_path  # noqa: F401``), which makes them its
fixtures:

- ``delete_tmp_path`` removes a test's ``tmp_path`` when the test ends,
  passed or failed: a driver run's checkpoints are hundreds of MB, and
  pytest keeps the directories of its last three sessions.
- ``delete_module_tmp`` removes, when the module ends, every directory
  made under the session's base directory while the module ran: those of
  its module-scoped fixtures (``tmp_path_factory.mktemp``) and of the
  ranks and subprocesses they hand them to. Each pytest-xdist worker has
  its own base directory and runs one module at a time.
"""
import shutil

import pytest


@pytest.fixture(autouse=True)
def delete_tmp_path(request):
    path = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(autouse=True, scope="module")
def delete_module_tmp(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    before = set(base.iterdir())
    yield
    for path in set(base.iterdir()) - before:
        shutil.rmtree(path, ignore_errors=True)
