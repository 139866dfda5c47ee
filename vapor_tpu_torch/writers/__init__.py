from .tsv import initiate_output, append_result_row
from .vcf import annotate_vcf
