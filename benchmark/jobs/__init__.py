"""Job drivers, one module a job, found by the ``job`` a traffic mix
names.  Each has a ``Job(ctx)`` class (``harness.Context``) with
``KIND``, ``UNITS`` (its end-to-end metrics' units), ``setup()``,
``window(seconds=, units=, spans=) -> (end-to-end values, units done,
seconds)``, ``failed()``, ``release()`` (frees the program's state),
``check() -> (numbers compared, kernel bounds)`` and
``control_readings()``."""
