"""Repository-wide pytest hooks: how ``--dist loadfile`` deals out tests.

Under ``-n N --dist loadfile`` pytest-xdist sends each test file whole
to one worker, so a run ends no sooner than its slowest file.
``tests/test_alc3.py`` holds 47 compile-heavy tests of the JAX
reference codec, which take about 1400 s on one CPU worker, while every
other file takes at most about 130 s.  That file is therefore dealt
out one test at a time, ahead of the other files; every other file
still goes whole to one worker.
"""

SPREAD_FILE = "tests/test_alc3.py"


def pytest_xdist_make_scheduler(config, log):
    if config.getoption("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class SpreadFileScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            path = super()._split_scope(nodeid)
            return nodeid if path == SPREAD_FILE else path

        def _assign_work_unit(self, node):
            # a whole-file scope has no "::": move those behind the tests of
            # SPREAD_FILE, which are the longest work of the run
            for scope in [s for s in self.workqueue if "::" not in s]:
                self.workqueue.move_to_end(scope)
            super()._assign_work_unit(node)

    return SpreadFileScheduling(config, log)
