"""Key generators, one module each, named by a traffic mix's
``keys.distribution``.  A module's ``keys(n, gen, **params)`` returns ``n``
int32 keys made on ``gen``'s device; ``params`` are the mix's other
``keys`` entries."""
