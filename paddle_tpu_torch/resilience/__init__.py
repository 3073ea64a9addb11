"""Resilience plane (counterpart of paddle_tpu/resilience/): the
deterministic, seeded fault injection of :mod:`.chaos`, whose sites the
serving plane plants (``serving.admit``, ``serving.decode_step``,
``memory.alloc``).  The guard, retry and soak modules are not ported."""
