from .genotype import organize_result, estimate_genotype
