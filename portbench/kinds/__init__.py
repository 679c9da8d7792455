"""One driver per kind of traffic (``traffic/<mix>.json`` names its
``kind``): each has a ``Traffic`` class with ``setup``, ``window``,
``stretch``, ``release`` and ``check``, and the names of its host spans."""
