"""Model code: MLA attention, MoE/MLP FFNs, the transformer stack."""
