"""NetClone's switch data plane and the discrete-event simulator: header
fields and packets, the Algorithm-1 tables, the switch in its exact scalar
form and its batched tensor form (:mod:`repro_torch.core.switch`), the
DES policies, workloads and simulator (numpy copies of ``repro.core``)."""
