"""Temporary trees of the port's test files, released once their tests are
done.

pytest keeps every test's temporary directory (retention policy ``all``)
and the base directories of its last three sessions, and a resnet18
checkpoint is ~46 MB: a session of the whole suite leaves gigabytes behind,
and a disk that fills turns the next write, wherever it lands, into an
error.  So the port's files remove what they write:

- a module fixture built on ``tmp_path_factory`` yields its result and
  then ``release``-s its tree;
- a file that imports ``tmp_path`` from here gets pytest's ``tmp_path``,
  removed once its test is done (passed or not)::

      from torch_tmp import release, tmp_path  # noqa: F401  (a fixture)
"""

import shutil

import pytest


def release(path) -> None:
    """Remove a temporary tree and everything under it."""
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, released after its test."""
    yield tmp_path
    release(tmp_path)
