"""Model layers of the port (global attention + MoE decoder)."""
