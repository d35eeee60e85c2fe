"""100 x the token-expert pairs the window's prefills routed (`generate`'s
`prefill_moe_routed`: k per real prompt token per expert layer that
`moe_mlp` ran) over the rows their expert products ran over
(`prefill_expert_rows`, as `moe_mlp` counts them): the share of the
routed FFN's prefill work that a token was routed to. Evaluated dense
per expert over padded chunks it reads k / E times the token use. None
where the program does not count them, or where no layer has experts."""


def read(run):
    routed = computed = 0
    for c in run.calls:
        if "prefill_expert_rows" not in c.stats:
            return None
        routed += c.stats["prefill_moe_routed"]
        computed += c.stats["prefill_expert_rows"]
    return 100.0 * routed / computed if computed else None
