"""Every ``soak`` test is also ``slow``.

Tier-1 runs ``pytest -m 'not slow'``, and a ``-m`` on the command line
replaces pyproject.toml's ``addopts = "-m 'not soak'"``.  Marking the
soak tests ``slow`` here keeps the hour-long runs out of tier-1, while
``-m soak`` still selects them and plain ``pytest`` still leaves them
out."""

import pytest


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # tryfirst: the marks must be on before ``-m`` deselects
    for item in items:
        if item.get_closest_marker("soak"):
            item.add_marker(pytest.mark.slow)
