from repro_torch.sharding.rules import PARAM_RULES, AxisRules, current_rules, spec, use_rules

__all__ = ["PARAM_RULES", "AxisRules", "current_rules", "spec", "use_rules"]
