"""Resilience plane (counterpart of paddle_tpu/resilience/): the
deterministic, seeded fault injection of :mod:`.chaos`, whose sites the
serving plane and the trainer plant (``serving.admit``,
``serving.decode_step``, ``memory.alloc``, ``trainer.step``), and the
trainer's numeric guard (:mod:`.guard`).  The retry, soak and elastic
worker modules are not ported."""
