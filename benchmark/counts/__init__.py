"""The yardstick's work counts: the compulsory bytes and the operations of
each hand-written kernel and of the whole step, from the configuration's
shapes alone (frozen copies of ``chip_smoke.py``'s hand counts, which this
package does not import), and the card's published peaks.

Each count takes a ``Shape`` (``shape.Shape.of(config)``): the grid's
sizes and halo, whether it is tripolar and immersed, the tracers, the
schemes and the equation of state, as the configuration file states them.
"""
