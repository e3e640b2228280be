"""The yardstick's own counts: operations of the reference networks, the
mosaic's least bytes, and the card's published peaks. They count the work
the configuration asks for, whatever implements it."""
