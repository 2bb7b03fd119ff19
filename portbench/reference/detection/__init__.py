"""The plain reference of ``detect``: the port's plain host routes, frozen,
and a matching scan of its own (``pipeline.py`` says which), with no kernel
of the program, no device-stage route and no native library."""
