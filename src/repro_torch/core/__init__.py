"""Switch data plane: header constants, Algorithm-1 tables, and the batched
tensor form of the switch tick (:mod:`repro_torch.core.switch`)."""
