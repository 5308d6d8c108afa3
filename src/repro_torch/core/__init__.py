"""Core of the port: semirings, control transforms, plans and the
crossbar, the plan algebra, plan programs and the static registry."""
