"""One driver per kind of traffic (a traffic file's ``kind``): it builds the
program at the configuration's sizes, makes the traffic from the seed,
warms up, steps the program one item at a time, and checks what the
program produced against the plain reference.

A driver is a class ``Driver(cell, seed, device)`` with ``unit`` (the
traffic key ``traced_<unit>`` says how many items a traced stretch runs),
``step()`` (one item; returns its latency in seconds), ``finish()`` (the
answers the check needs that the window left undone, untimed),
``counts()``, ``describe()`` (a line for the log), ``release()`` (frees the program's state), ``check()``
(a list of (name, value, limit)), ``attempted_outside_window`` and
``failed``."""
